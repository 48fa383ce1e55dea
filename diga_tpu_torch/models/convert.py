"""Weights across the two packages, in the reference state_dict layout.

``state_dict_from_jax`` is the port's own copy of the
``diga_tpu/models/convert.py::segmodel_to_torch`` mapping (:114-154): it
turns the JAX package's DeepLabV2 parameters and batch statistics, as
nested dicts of numpy arrays, into a state_dict with the reference keys,
which ``DeepLabV2.load_state_dict(..., strict=True)`` takes.  The BN
``num_batches_tracked`` counters are not part of the reference layout;
``nn.BatchNorm2d`` fills them in when a state_dict without them loads.

Layout rules:
  conv   flax kernel (kh, kw, I, O) -> torch (O, I, kh, kw)
  linear flax kernel (I, O)         -> torch (O, I)
  BN     scale/bias (params), mean/var (batch_stats) ->
         weight/bias/running_mean/running_var
  GN     scale/bias -> weight/bias

``translator_state_dict_from_jax`` is the port's own copy of
``diga_tpu/models/convert_translator.py``'s ``encoder_to_torch``,
``decoder_to_torch`` and ``discriminator_to_torch`` (:72-126): the JAX
translator's parameters become the six reference role state_dicts, which
the port's ``ImgEncoder``/``ImgDecoder``/``Discriminator`` load with
``strict=True``.  ``pretrained_backbone_state_dict`` lays a reference
ResNet-101 ``.pth`` over a fresh DeepLabV2 (``--pretrained_backbone``).

``hrnet_state_dict_from_jax`` is the port's own copy of
``diga_tpu/models/convert_hrnet.py::hrnet_ocr_to_torch`` (:203-290): the JAX
HRNet+OCR's parameters and batch statistics in the reference SegModel
layout (``hrnet.*``, ``ocrnet.*``), which ``HRNetOCR`` loads with
``strict=True``; it lists the keys in ``HRNetOCR.state_dict()``'s order.
``hrnet_imagenet_state_dict`` is the port's copy of ``hrnet_imagenet_init``
(:146-200), the ImageNet hrnetv2 init of ``--pretrained_backbone``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def state_dict_from_jax(params: dict, batch_stats: dict,
                        layers=(3, 4, 23, 3)) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}

    def put_conv(key, node):
        sd[key + ".weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            sd[key + ".bias"] = _tensor(node["bias"])

    def put_linear(key, node):
        sd[key + ".weight"] = _tensor(np.asarray(node["kernel"]).transpose(1, 0))
        sd[key + ".bias"] = _tensor(node["bias"])

    def put_bn(key, pnode, snode):
        sd[key + ".weight"] = _tensor(pnode["frozen_bn"]["scale"])
        sd[key + ".bias"] = _tensor(pnode["frozen_bn"]["bias"])
        sd[key + ".running_mean"] = _tensor(snode["frozen_bn"]["mean"])
        sd[key + ".running_var"] = _tensor(snode["frozen_bn"]["var"])

    def put_gn(key, node):
        sd[key + ".weight"] = _tensor(node["scale"])
        sd[key + ".bias"] = _tensor(node["bias"])

    put_conv("layer0.0", params["conv1"])
    put_bn("layer0.1", params["bn1"], batch_stats["bn1"])
    for li, n_blocks in enumerate(layers, start=1):
        for bi in range(n_blocks):
            p = params[f"layer{li}"][f"block{bi}"]
            s = batch_stats[f"layer{li}"][f"block{bi}"]
            for ci in (1, 2, 3):
                put_conv(f"layer{li}.{bi}.conv{ci}", p[f"conv{ci}"])
                put_bn(f"layer{li}.{bi}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                put_conv(f"layer{li}.{bi}.downsample.0", p["downsample_conv"])
                put_bn(f"layer{li}.{bi}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    h = params["head"]
    for j in range(5):
        put_conv(f"final.conv2d_list.{j}.0", h[f"branch{j}_conv"])
        put_gn(f"final.conv2d_list.{j}.1", h[f"branch{j}_gn"])
    put_linear("final.bottleneck.0.se.0", h["se"]["fc1"])
    put_linear("final.bottleneck.0.se.2", h["se"]["fc2"])
    put_conv("final.bottleneck.1", h["bottleneck_conv"])
    put_gn("final.bottleneck.2", h["bottleneck_gn"])
    put_conv("final.head.1", h["classifier"])
    return sd


def _put_conv_block(sd: dict, key: str, node: dict) -> None:
    conv = node["conv"]
    sd[key + ".conv.weight"] = _tensor(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        sd[key + ".conv.bias"] = _tensor(conv["bias"])


def _put_res_blocks(sd: dict, key: str, params: dict, n_res: int) -> None:
    for r in range(n_res):
        for j in (0, 1):
            _put_conv_block(sd, f"{key}.model.{r}.model.{j}", params[f"res{r}"][f"conv{j}"])


def _put_encoder(params: dict) -> dict[str, torch.Tensor]:
    n_down = sum(1 for k in params if k.startswith("down"))
    sd: dict[str, torch.Tensor] = {}
    _put_conv_block(sd, "model.0", params["stem"])
    for i in range(n_down):
        _put_conv_block(sd, f"model.{1 + i}", params[f"down{i}"])
    _put_res_blocks(sd, f"model.{1 + n_down}", params, sum(1 for k in params if k.startswith("res")))
    return sd


def _put_decoder(params: dict) -> dict[str, torch.Tensor]:
    n_up = sum(1 for k in params if k.startswith("up"))
    sd: dict[str, torch.Tensor] = {}
    _put_res_blocks(sd, "model.0", params, sum(1 for k in params if k.startswith("res")))
    # layout: [ResBlocks, (upsample, up-conv) x n_up, out conv]
    for i in range(n_up):
        _put_conv_block(sd, f"model.{2 + 2 * i}", params[f"up{i}"])
    _put_conv_block(sd, f"model.{1 + 2 * n_up}", params["out"])
    return sd


def _put_discriminator(params: dict) -> dict[str, torch.Tensor]:
    n_scales = sum(1 for k in params if k.endswith("_head"))
    n_layer = sum(1 for k in params if k.startswith("scale0_conv"))
    sd: dict[str, torch.Tensor] = {}
    for s in range(n_scales):
        for j in range(n_layer):
            _put_conv_block(sd, f"cnns.{s}.{j}", params[f"scale{s}_conv{j}"])
        head = params[f"scale{s}_head"]
        sd[f"cnns.{s}.{n_layer}.weight"] = _tensor(np.asarray(head["kernel"]).transpose(3, 2, 0, 1))
        sd[f"cnns.{s}.{n_layer}.bias"] = _tensor(head["bias"])
    return sd


_TRANSLATOR_LAYOUTS = {"enc": _put_encoder, "dec": _put_decoder, "dis": _put_discriminator}


def translator_state_dict_from_jax(params: dict[str, dict]) -> dict[str, dict]:
    """{role: state_dict} from the JAX translator's parameter trees by role
    (``enc_s``/``enc_t``: ImgEncoder, ``dec_s2t``/``dec_t2s``: ImgDecoder,
    ``dis_s2t``/``dis_t2s``: Discriminator; nested dicts of arrays)."""
    return {role: _TRANSLATOR_LAYOUTS[role.split("_")[0]](p) for role, p in params.items()}


def pretrained_backbone_state_dict(model: torch.nn.Module,
                                   sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``model``'s state_dict with a reference ResNet-101 ``.pth`` laid over it.

    The port's counterpart of ``diga_tpu/models/convert.py``'s
    ``segmodel_from_torch`` + ``merge_pretrained_backbone`` (:66-175), the
    reference's DeeplabMulti load rule (seg_model_noaux.py:328-347).  Both
    namings are read: the raw ``ResNetMulti`` (``conv1``, ``bn1``,
    ``layer1``-``layer4``, head ``layer5``; the Caffe init) and the
    ``SegModel`` wrapper's (``layer0.0``, ``layer0.1``, head ``final``).
    Every backbone entry of ``model`` must be in ``sd`` (a model shallower
    than the file takes its first blocks, as the JAX converter walks only
    the model's depth).  The head is laid over only when ``sd`` holds the
    ASPP head of this model's layout and class count; otherwise it keeps its
    fresh init (the Caffe file's head is another module).
    """
    wrapper = any(k.startswith("layer0.") for k in sd)
    head = "final." if wrapper else "layer5."
    rename = {} if wrapper else {"conv1.": "layer0.0.", "bn1.": "layer0.1."}
    src: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        for old, new in rename.items():
            if k.startswith(old):
                k = new + k[len(old):]
        if k.startswith(head):
            k = "final." + k[len(head):]
        src[k] = torch.as_tensor(v)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    out = dict(model.state_dict())
    backbone = [k for k in own if not k.startswith("final.")]
    missing = [k for k in backbone if k not in src]
    if missing:
        raise KeyError(f"the backbone file lacks {len(missing)} entries of the model, e.g. "
                       f"{missing[:3]}")
    head_keys = [k for k in own if k.startswith("final.")]
    take_head = all(k in src and src[k].shape == own[k].shape for k in head_keys)
    for k in backbone + (head_keys if take_head else []):
        if src[k].shape != own[k].shape:
            raise ValueError(f"{k}: {tuple(src[k].shape)} in the file, {tuple(own[k].shape)} "
                             "in the model")
        out[k] = src[k].to(own[k].dtype)
    return out


def hrnet_state_dict_from_jax(params: dict, batch_stats: dict,
                              arch: dict) -> dict[str, torch.Tensor]:
    """The JAX HRNetOCR's (params, batch_stats) as the reference state_dict.

    The JAX ConvBN's conv has no bias; the reference keeps one on two OCR
    convs before a BN, which the JAX converter emits as zeros (the port's
    ``BufferBiasConv2d``), here next to its conv's weight."""
    sd: dict[str, torch.Tensor] = {}

    def put_convbn(conv_key, bn_key, pnode, snode, conv_bias=False):
        kernel = np.asarray(pnode["conv"]["kernel"])
        sd[conv_key + ".weight"] = _tensor(kernel.transpose(3, 2, 0, 1))
        if conv_bias:
            sd[conv_key + ".bias"] = torch.zeros(kernel.shape[-1])
        sd[bn_key + ".weight"] = _tensor(pnode["bn"]["scale"])
        sd[bn_key + ".bias"] = _tensor(pnode["bn"]["bias"])
        sd[bn_key + ".running_mean"] = _tensor(snode["bn"]["mean"])
        sd[bn_key + ".running_var"] = _tensor(snode["bn"]["var"])

    def put_seq(key, pnode, snode, conv_bias=False):
        put_convbn(key + ".0", key + ".1", pnode, snode, conv_bias)

    def put_conv(key, node):
        sd[key + ".weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        sd[key + ".bias"] = _tensor(node["bias"])

    hp, hs = params["hrnet"], batch_stats["hrnet"]
    put_convbn("hrnet.conv1", "hrnet.bn1", hp["stem1"], hs["stem1"])
    put_convbn("hrnet.conv2", "hrnet.bn2", hp["stem2"], hs["stem2"])
    for i in range(arch["stage1_blocks"]):
        base, blk = f"hrnet.stage1.{i}", f"stage1_block{i}"
        for c in (1, 2, 3):
            put_convbn(f"{base}.conv{c}", f"{base}.bn{c}", hp[blk][f"conv{c}"], hs[blk][f"conv{c}"])
        if "downsample" in hp[blk]:
            put_seq(f"{base}.downsample", hp[blk]["downsample"], hs[blk]["downsample"])
    prev = 1
    for si, (num_modules, num_blocks, channels) in enumerate(arch["stages"], start=2):
        trans = f"hrnet.transition_stage_{si - 1}_{si}"
        for i in range(len(channels)):
            if i < prev:
                if f"trans{si}_{i}" in hp:
                    put_seq(f"{trans}.{i}", hp[f"trans{si}_{i}"], hs[f"trans{si}_{i}"])
            else:
                for j in range(i + 1 - prev):
                    put_seq(f"{trans}.{i}.{j}", hp[f"trans{si}_{i}_{j}"], hs[f"trans{si}_{i}_{j}"])
        for m in range(num_modules):
            mbase = f"hrnet.stage{si}.{m}"
            mp, ms = hp[f"stage{si}_module{m}"], hs[f"stage{si}_module{m}"]
            for bi in range(len(channels)):
                for k in range(num_blocks):
                    blk, bp, bs = (f"{mbase}.branches.{bi}.{k}", mp[f"branch{bi}_block{k}"],
                                   ms[f"branch{bi}_block{k}"])
                    for c in (1, 2):
                        put_convbn(f"{blk}.conv{c}", f"{blk}.bn{c}", bp[f"conv{c}"], bs[f"conv{c}"])
                    if "downsample" in bp:
                        put_seq(f"{blk}.downsample", bp["downsample"], bs["downsample"])
            for i in range(len(channels)):
                for j in range(len(channels)):
                    if j > i:
                        put_seq(f"{mbase}.fuse_layers.{i}.{j}", mp[f"fuse{i}_{j}"],
                                ms[f"fuse{i}_{j}"])
                    for k in range(i - j):
                        put_seq(f"{mbase}.fuse_layers.{i}.{j}.{k}", mp[f"fuse{i}_{j}_{k}"],
                                ms[f"fuse{i}_{j}_{k}"])
        prev = len(channels)

    op, os_ = params["ocr"], batch_stats["ocr"]
    put_seq("ocrnet.pixel_representations", op["pixel_rep"], os_["pixel_rep"], conv_bias=True)
    put_seq("ocrnet.soft_object_regions", op["region_conv"], os_["region_conv"], conv_bias=True)
    put_conv("ocrnet.soft_object_regions.3", op["region_cls"])
    for tname, fname in (("pixel_rep", "query"), ("obj_reg_rep", "key")):
        rel = f"ocrnet.pixel_region_relations.{tname}"
        put_convbn(f"{rel}.0", f"{rel}.1", op[f"{fname}_a"], os_[f"{fname}_a"])
        put_convbn(f"{rel}.3", f"{rel}.4", op[f"{fname}_b"], os_[f"{fname}_b"])
    put_seq("ocrnet.value", op["value"], os_["value"])
    put_seq("ocrnet.ocr_up", op["ocr_up"], os_["ocr_up"])
    put_seq("ocrnet.augmented_rep", op["augment"], os_["augment"])
    put_conv("ocrnet.segmentation_classes.0", op["cls"])
    return sd


_TENSOR_KINDS = ("weight", "bias", "running_mean", "running_var")


def hrnet_imagenet_state_dict(model: torch.nn.Module,
                              pretrained_sd: dict) -> dict[str, torch.Tensor]:
    """``model``'s state_dict with an ImageNet hrnetv2 checkpoint laid over
    its backbone.

    The reference pairs the checkpoint's tensors with the backbone's by
    position (hrnet_module.py:573-584), so this does: the model's
    ``hrnet.*`` tensors in registration order against the checkpoint's,
    after stripping a DataParallel ``module.`` prefix and dropping
    ``num_batches_tracked``; the zip stops where either ends (the ImageNet
    classifier trails the backbone).  The OCR head keeps its init.  Raises
    a ``RuntimeError``, as the JAX ``hrnet_imagenet_init`` does, where a
    checkpoint with standard names does not start at ``conv1.weight`` or
    is shorter than the backbone, and where a pair differs in shape or, for
    a checkpoint key with a tensor-kind suffix, in that suffix.
    """
    out = dict(model.state_dict())
    back_keys = [k for k in out if k.startswith("hrnet.") and not k.endswith("num_batches_tracked")]
    pre_items = [(k[7:] if k.startswith("module.") else k, torch.as_tensor(v))
                 for k, v in pretrained_sd.items() if "num_batches_tracked" not in k]
    if pre_items and pre_items[0][0].split(".")[0].startswith("conv"):
        if pre_items[0][0] != "conv1.weight":
            raise RuntimeError(
                f"hrnet ImageNet init: checkpoint's first tensor is {pre_items[0][0]!r}, "
                "expected 'conv1.weight' — wrong or reordered checkpoint")
        if len(pre_items) < len(back_keys):
            raise RuntimeError(
                f"hrnet ImageNet init: checkpoint has {len(pre_items)} tensors < backbone's "
                f"{len(back_keys)} — truncated dump")
    for ours, (pk, pv) in zip(back_keys, pre_items):
        if tuple(out[ours].shape) != tuple(pv.shape):
            raise RuntimeError(
                f"hrnet ImageNet init: shape mismatch at {ours} <- {pk}: "
                f"{tuple(out[ours].shape)} vs {tuple(pv.shape)} — pretrained weights could not "
                "be correctly loaded")
        suffix = pk.rsplit(".", 1)[-1]
        if suffix in _TENSOR_KINDS and suffix != ours.rsplit(".", 1)[-1]:
            raise RuntimeError(
                f"hrnet ImageNet init: positional pairing misaligned at {ours} <- {pk} "
                "(tensor-kind suffix mismatch)")
        out[ours] = pv.to(out[ours].dtype)
    return out


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat dict of CPU tensors.

    Counterpart of ``diga_tpu/models/convert.py::load_torch_state_dict``
    (:42-52): unwraps a saved module and a ``{"state_dict": ...}`` wrapper
    (SimCLRv2/ProDA-style checkpoints, reference seg_model_noaux.py:339).
    """
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}
