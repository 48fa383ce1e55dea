"""The data-parallel pieces of ``diga_tpu_torch.parallel`` against ``diga_tpu``.

One world of 2 gloo ranks on the CPU (``dist.launch``, a ``file://``
rendezvous, one torch thread a rank) runs ``_torch_port_parallel_sub.units``
on each rank's share of global inputs made with numpy; the JAX package's
counterparts see the global inputs:

  * ``SyncBatchNorm2d`` (swapped in by ``convert_sync_bn`` only under a
    group): the forward, the input and affine gradients of sum(y·g) and the
    running statistics against ``nn.BatchNorm2d`` and JAX ``BatchNorm2D``
    on the global batch, atol 1e-5 / rtol 1e-4;
  * the host-sharded loaders: each rank's names and pixels against JAX's
    ``BatchLoader(host_id, host_count)``, bit for bit, and the ranks'
    batches concatenated against the one-host batch; ``make_train_iterator``
    under the group against the one-process iterator at twice the batch;
  * global OHEM: the ranks' average loss and d(global loss)/d(logits)
    against JAX ``ohem_cross_entropy`` on the global batch;
  * the centroid scan over the gathered rows against JAX
    ``update_centroids`` on the global batch;
  * batch-sharded two-scale eval over 3 images (the tail padded): the
    confusion matrix and every score equal to one process's, exactly;
  * the rows a rank keeps of a global draw, broadcast and the gradient
    all-reduce.

Also: no group changes nothing; a dead rank makes its peer raise within
the group's timeout; more ranks than cards raise; ``dryrun_multichip(2)``.
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

import _torch_port_parallel_sub as sub
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.parallel import dist
from diga_tpu_torch.parallel.sync_bn import SyncBatchNorm2d, convert_sync_bn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread in this process and so in each rank it
    spawns (a rank gets its launcher's threads over the world size)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

ATOL, RTOL = 1e-5, 1e-4
WORLD = 2


def _close(ours, want, name=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def _cat(every, key):
    return np.concatenate([e[key] for e in every], axis=0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_units")
    rr = np.random.default_rng(0)
    c = 6
    ohem_labels = rr.integers(0, 5, size=(4, 8, 10)).astype(np.int32)
    ohem_labels[:, :2] = 255
    gta_list = synthetic.make_gta5_fixture(str(root / "gta"), n=7, h=40, w=72)
    img_list, lbl_list = synthetic.make_cityscapes_fixture(str(root / "city"), n=4, h=40, w=72,
                                                           split="train")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(root / "city"), n=3, h=40, w=72,
                                                         split="val")
    cfg = sub.tiny_dg_preset()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, source_root=str(root / "gta"), source_list=gta_list,
        target_root=str(root / "city"), target_img_list=img_list, target_lbl_list=lbl_list))
    return {
        "bn_x": (rr.normal(size=(4, c, 5, 7)) * 2.0 + 1.5).astype(np.float32),
        "bn_g": rr.normal(size=(4, c, 5, 7)).astype(np.float32),
        "bn_state": {"weight": rr.normal(size=c).astype(np.float32),
                     "bias": rr.normal(size=c).astype(np.float32),
                     "running_mean": rr.normal(size=c).astype(np.float32),
                     "running_var": rr.uniform(0.5, 2.0, size=c).astype(np.float32),
                     "num_batches_tracked": np.array(0)},
        "ohem_logits": (rr.normal(size=(4, 8, 10, 5)) * 2.0).astype(np.float32),
        "ohem_labels": ohem_labels, "ohem_thresh": 0.7, "ohem_min_kept": 30,
        "cent_vectors": rr.normal(size=(5, 3)).astype(np.float32),
        "cent_counts": np.array([0.0, 50.0, 99.0, 100.0, 2999.5], np.float32),
        "cent_batch": rr.normal(size=(4, 5, 3)).astype(np.float32),
        "cent_ok": rr.random((4, 5)) < 0.7,
        "loader": {"root": str(root / "gta"), "list": gta_list, "hw": (40, 72),
                   "crop": (32, 64), "batch": 2, "seed": 5},
        "train_cfg": cfg,
        "eval": {"root": str(root / "city"), "img_list": val_img, "lbl_list": val_lbl,
                 "hw": (40, 72), "ds_hw": (20, 36), "batch": 1},
    }


@pytest.fixture(scope="module")
def every(data, one_thread):
    mp = pytest.MonkeyPatch()
    mp.setenv(dist.PG_TIMEOUT_ENV, "120")
    try:
        return dist.launch(sub.units, WORLD, "cpu", (data,), join_timeout_s=300)
    finally:
        mp.undo()


def _global_bn(data):
    bn = nn.BatchNorm2d(data["bn_x"].shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in data["bn_state"].items()})
    x = torch.from_numpy(data["bn_x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(data["bn_g"])).sum().backward()
    return bn, x, y


def test_the_world_forms_over_gloo(every):
    assert [(e["rank"], e["world"], e["backend"]) for e in every] == [(0, 2, "gloo"),
                                                                     (1, 2, "gloo")]


def test_sync_bn_is_swapped_in_only_under_a_group(every):
    assert all(e["bn_class"] == "SyncBatchNorm2d" and e["bn_is_sync"] for e in every)
    model = nn.Sequential(nn.BatchNorm2d(4))
    model[0].weight.requires_grad_(False)
    keys = list(model.state_dict())
    assert convert_sync_bn(model) is model and type(model[0]) is nn.BatchNorm2d  # no group
    sync = nn.BatchNorm2d(4)
    sync.weight.requires_grad_(False)
    sync.__class__ = SyncBatchNorm2d
    assert list(nn.Sequential(sync).state_dict()) == keys
    assert not sync.weight.requires_grad and sync.bias.requires_grad


def test_sync_bn_matches_torch_bn_on_the_global_batch(data, every):
    bn, x, y = _global_bn(data)
    _close(_cat(every, "bn_y"), y.detach(), "forward")
    _close(_cat(every, "bn_dx"), x.grad, "input gradient")
    for e in every:
        _close(e["bn_dw"], bn.weight.grad, "weight gradient")
        _close(e["bn_db"], bn.bias.grad, "bias gradient")
        for k in ("running_mean", "running_var"):
            _close(e["bn_running"][k], getattr(bn, k).detach(), k)
        assert int(e["bn_running"]["num_batches_tracked"]) == 1
    bn.eval()
    _close(_cat(every, "bn_eval_y"), bn(torch.from_numpy(data["bn_x"])).detach(), "eval")


def test_sync_bn_matches_jax_batchnorm2d_on_the_global_batch(data, every):
    from diga_tpu.models.norms import BatchNorm2D

    st = data["bn_state"]
    x = jnp.asarray(data["bn_x"].transpose(0, 2, 3, 1))
    g = jnp.asarray(data["bn_g"].transpose(0, 2, 3, 1))
    variables = {"params": {"scale": jnp.asarray(st["weight"]), "bias": jnp.asarray(st["bias"])},
                 "batch_stats": {"mean": jnp.asarray(st["running_mean"]),
                                 "var": jnp.asarray(st["running_var"])}}
    mod = BatchNorm2D()

    def loss(params, x):
        y, upd = mod.apply({**variables, "params": params}, x, train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], x)
    _close(_cat(every, "bn_y"), np.asarray(y).transpose(0, 3, 1, 2), "forward")
    _close(_cat(every, "bn_dx"), np.asarray(dx).transpose(0, 3, 1, 2), "input gradient")
    for e in every:
        _close(e["bn_dw"], dp["scale"], "scale gradient")
        _close(e["bn_db"], dp["bias"], "bias gradient")
        _close(e["bn_running"]["running_mean"], upd["batch_stats"]["mean"], "running mean")
        _close(e["bn_running"]["running_var"], upd["batch_stats"]["var"], "running var")


def _jax_loader(ld, host_id, host_count, batch):
    from diga_tpu.data import Compose, RandomCrop, RandomHorizontallyFlip, gta5_dataset
    from diga_tpu.data.pipeline import BatchLoader

    ds = gta5_dataset(ld["root"], ld["list"], resize_hw=ld["hw"],
                      transform=Compose([RandomHorizontallyFlip(), RandomCrop(list(ld["crop"]))]))
    loader = BatchLoader(ds, batch_size=batch, seed=ld["seed"], num_workers=1,
                         host_id=host_id, host_count=host_count)
    it = iter(loader)
    out = [next(it) for _ in range(2)]
    loader.stop()
    return out


def test_loader_rows_per_rank_match_jax_batchloader(data, every):
    ld = data["loader"]
    for r, e in enumerate(every):
        want = _jax_loader(ld, r, WORLD, ld["batch"])
        for ours, ref in zip(e["loader"], want):
            assert ours["name"] == ref["name"]
            np.testing.assert_array_equal(ours["image"], ref["image"])
            np.testing.assert_array_equal(ours["label"], ref["label"])


def test_loader_ranks_concatenated_are_the_one_host_batch(data, every):
    from diga_tpu_torch.data.loader import BatchLoader

    ld = data["loader"]
    loader = BatchLoader(sub.loader_dataset(ld), batch_size=ld["batch"] * WORLD, seed=ld["seed"],
                         num_workers=1)
    it = iter(loader)
    one = [next(it) for _ in range(2)]
    loader.stop()
    for b, ref in enumerate(one):
        assert sum((e["loader"][b]["name"] for e in every), []) == ref["name"]
        np.testing.assert_array_equal(
            np.concatenate([e["loader"][b]["image"] for e in every]), ref["image"])


def test_train_iterator_is_host_sharded(data, every):
    from diga_tpu_torch.train.loop import make_train_iterator

    cfg = data["train_cfg"]
    double = lambda streams: tuple(dataclasses.replace(s, batch=s.batch * WORLD)
                                   for s in streams)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, source_streams=double(cfg.data.source_streams),
        target_streams=double(cfg.data.target_streams)))
    it, loaders = make_train_iterator(cfg, with_target=True)
    one = next(it)
    for ld in loaders:
        ld.stop()
    # each stream's rows interleave: stream by stream, rank by rank within one
    for key, nstreams in (("s_img", 2), ("t_img", 2), ("s_lbl", 2)):
        parts = [np.split(e["train_batch"][key], nstreams) for e in every]
        want = np.split(one[key], nstreams)
        for s in range(nstreams):
            np.testing.assert_array_equal(np.concatenate([p[s] for p in parts]), want[s])


def test_ohem_matches_jax_on_the_global_batch(data, every):
    from diga_tpu.ops.losses import ohem_cross_entropy

    fn = lambda lg: ohem_cross_entropy(lg, jnp.asarray(data["ohem_labels"]),
                                       thresh=data["ohem_thresh"],
                                       min_kept=data["ohem_min_kept"])
    value, grad = jax.value_and_grad(fn)(jnp.asarray(data["ohem_logits"]))
    for e in every:
        assert e["ohem_loss"] == pytest.approx(float(value), rel=RTOL, abs=ATOL)
    _close(_cat(every, "ohem_grad"), grad, "OHEM gradient")
    assert np.count_nonzero(np.abs(np.asarray(grad)).sum(-1)) < data["ohem_labels"].size


def test_centroid_scan_matches_jax_on_the_global_batch(data, every):
    from diga_tpu.ops.prototypes import Centroids, update_centroids

    want = update_centroids(Centroids(jnp.asarray(data["cent_vectors"]),
                                      jnp.asarray(data["cent_counts"])),
                            jnp.asarray(data["cent_batch"]), jnp.asarray(data["cent_ok"]),
                            start_mean=True)
    for e in every:
        np.testing.assert_array_equal(e["cent_counts"], np.asarray(want.counts))
        _close(e["cent_vectors"], want.vectors, "centroid vectors")


def test_sharded_eval_with_a_padded_tail_equals_one_process(data, every):
    one = sub.sharded_eval(data["eval"])  # no group here: one process, every image
    assert [len(e["eval"]["names"]) for e in every] == [2, 1]
    assert sorted(sum((e["eval"]["names"] for e in every), [])) == sorted(one["names"])
    for e in every:
        np.testing.assert_array_equal(e["eval"]["confusion"], one["confusion"])
        assert e["eval"]["scores"] == one["scores"]
    assert math.isfinite(one["scores"]["mean_iou"]) and one["confusion"].sum() > 0


def test_rows_of_a_global_draw_broadcast_and_grad_mean(every):
    assert [e["rows_one"] for e in every] == [[0, 1], [2, 3]]
    # parts (2, 3) of a world of 2: [p0 r0, p0 r1, p1 r0, p1 r1]
    assert [e["rows_parts"] for e in every] == [[0, 1, 4, 5, 6], [2, 3, 7, 8, 9]]
    full = np.arange(12.0).reshape(4, 3)
    for r, e in enumerate(every):
        np.testing.assert_array_equal(e["drawn"], full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(e["broadcast"][0], np.ones((2, 3)))
        np.testing.assert_array_equal(e["broadcast"][1], np.full(2, 10.0))
        np.testing.assert_array_equal(e["grad_mean"], np.full((2, 3), 1.5))
        assert e["bias_grad"] is None


def test_without_a_group_nothing_changes():
    assert not dist.active() and (dist.rank(), dist.world()) == (0, 1) and dist.is_writer()
    g = torch.Generator().manual_seed(3)
    drawn = dist.draw_local(lambda n: torch.rand(n, 2, generator=g), 3)
    np.testing.assert_array_equal(drawn, torch.rand(3, 2, generator=torch.Generator()
                                                   .manual_seed(3)))
    t = torch.arange(4.0)
    assert dist.gather_rows(t) is t and dist.all_reduce_sum(t) is t
    metrics = {"loss": torch.tensor(1.0)}
    assert dist.mean_metrics(metrics) is metrics
    p = nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    dist.all_reduce_grads([p])
    assert p.grad.tolist() == [3.0, 3.0]


def test_more_ranks_than_cards_and_multihost_without_torchrun_raise(monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        dist.check_devices(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="at least 1"):
        dist.check_devices(0, "cpu")
    for k in dist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        dist.launch(lambda: None, 1, "cpu", multihost=True)
    assert not dist.active()


def test_a_dead_rank_makes_its_peer_raise_within_the_timeout(monkeypatch):
    monkeypatch.setenv(dist.PG_TIMEOUT_ENV, "20")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        dist.launch(sub.dead_rank, WORLD, "cpu", join_timeout_s=120)
    assert time.monotonic() - t0 < 90
    msg = str(err.value)
    assert "2 of 2 ranks failed" in msg and "rank 1: exited with code 3" in msg, msg


def test_dryrun_multichip_over_two_ranks():
    from diga_tpu_torch.parallel.dryrun import FAMILIES, dryrun_multichip

    out = dryrun_multichip(WORLD, "cpu")
    assert set(out) == set(FAMILIES)
    assert all(math.isfinite(v) for v in out.values()), out
