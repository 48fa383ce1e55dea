"""Tiny copies of the benchmark's cells, for the CPU tests.

The configuration keeps its kind and widths where they are cheap and cuts
depth (DeepLab (1, 1, 1, 1); an HRNet with branches 8-64 and OCR 32/16),
the crop (32x64) and the eval sizes (64x128 and 32x64); the traffic keeps
its recipe and limits.  A tiny copy of the cell's preset, computing in
f32, is registered in the port's preset table under ``tiny_<preset>``.
"""

from __future__ import annotations

import copy
import dataclasses

from benchmark.harness import manifest
from benchmark.harness.manifest import Cell

TINY_HRNET = {"stem_channels": 8, "stage1_blocks": 1, "stage1_channels": 8,
              "stages": [[1, 1, [8, 16]], [1, 1, [8, 16, 32]], [1, 1, [8, 16, 32, 64]]],
              "ocr_mid_channels": 32, "ocr_key_channels": 16}


def tiny_cell(name: str, compute_dtype: str = "float32") -> Cell:
    from diga_tpu_torch.configs import presets

    cell = manifest.resolve(name, manifest.load())
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["model"] == "deeplabv2":
        cfg["layers"] = [1, 1, 1, 1]
        cfg["program_extra"] = {"layers": [1, 1, 1, 1]}
    else:
        from diga_tpu_torch.models import hrnet_ocr

        hrnet_ocr.ARCHS["tiny"] = {**TINY_HRNET, "stages": [
            (m, b, tuple(c)) for m, b, c in TINY_HRNET["stages"]]}
        cfg["hrnet"] = TINY_HRNET
        cfg["program_extra"] = {"model": "hrnet_ocr", "hrnet_arch": "tiny", "feat_dim": 32}
    base = presets.get_preset(tr["preset"])
    train = dataclasses.replace(base.train, compute_dtype=compute_dtype)
    if tr["kind"] == "train":
        tr.update(crop_hw=[32, 64], label_block=8, trace_steps=2, warmup_steps=1)
        tr["recipe"]["crop_hw"] = [32, 64]
        train = dataclasses.replace(train, crop_hw=(32, 64))
    else:
        tr.update(out_hw=[64, 128], ds_hw=[32, 64], label_block=16, pool_images=3)
    name_t = f"tiny_{tr['preset']}"
    presets.PRESETS[name_t] = dataclasses.replace(
        base, name=name_t, train=train,
        eval=dataclasses.replace(base.eval, out_hw=(64, 128), ds_hw=(32, 64)))
    tr["preset"] = name_t
    return Cell(name, cfg, tr, cell.chips, cell.end_to_end, cell.per_layer)
