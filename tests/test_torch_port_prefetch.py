"""``data/prefetch.py::device_prefetch`` and the training loop that uses it (CPU).

* the batches come out in order with the same content, non-array values
  passed through, as CPU tensors on the CPU;
* it pulls at most ``buffer_size`` batches ahead of the one handed out
  (a counting source), and ends when its source ends;
* ``run_training`` on a tiny warm-up preset, which now prefetches, logs the
  same ``metrics.jsonl`` values as the same steps fed through ``to_device``
  by hand from the same loaders.
The card's side (a copy stream, an event, ``record_stream``) is held by
``chip_smoke.py``: 20 prefetched batches equal to their host copies under
real steps.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.data.prefetch import device_prefetch
from diga_tpu_torch.train.build import build_experiment, wants_target
from diga_tpu_torch.train.loop import make_train_iterator, run_training, to_device

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    these small models' many small ops only contend across more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(n: int) -> list[dict]:
    rr = np.random.default_rng(5)
    return [{"s_img": rr.normal(size=(2, 4, 6, 3)).astype(np.float32),
             "s_lbl": rr.integers(0, 19, size=(2, 4, 6)).astype(np.uint8),
             "name": [f"img{i}"]} for i in range(n)]


class Counting:
    """An iterator over ``items`` that counts how many it has handed out."""

    def __init__(self, items):
        self.items, self.pulled = list(items), 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pulled == len(self.items):
            raise StopIteration
        self.pulled += 1
        return self.items[self.pulled - 1]


def test_order_and_content_are_kept_on_cpu_tensors():
    host = _batches(5)
    out = list(device_prefetch(iter(host), CPU))
    assert len(out) == 5
    for got, want in zip(out, host):
        assert set(got) == set(want)
        assert got["name"] == want["name"]
        for k in ("s_img", "s_lbl"):
            assert isinstance(got[k], torch.Tensor) and got[k].device == CPU
            assert got[k].dtype == torch.from_numpy(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("buffer_size", [1, 2, 3])
def test_pulls_at_most_buffer_size_ahead(buffer_size):
    src = Counting(_batches(6))
    for i, _ in enumerate(device_prefetch(src, CPU, buffer_size=buffer_size)):
        # holding batch i, the source has handed out i + buffer_size at most
        assert src.pulled <= i + buffer_size, (i, src.pulled)
        assert src.pulled == min(i + buffer_size, 6)
    assert src.pulled == 6


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_ends_when_its_source_ends(n):
    src = Counting(_batches(n))
    it = device_prefetch(src, CPU, buffer_size=2)
    assert len(list(it)) == n
    with pytest.raises(StopIteration):
        next(it)


def _tiny_warmup():
    base = presets.get_preset("gta2city_warmup")
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=(presets.LoaderSpec("gta5", (40, 72), 1),
                            presets.LoaderSpec("gta5", (48, 80), 1)),
            target_streams=(presets.LoaderSpec("cityscapes", (40, 72), 1),
                            presets.LoaderSpec("cityscapes", (48, 80), 1))),
        train=dataclasses.replace(base.train, crop_hw=(32, 64), compute_dtype="float32",
                                  num_steps=3, eval_every=0),
        eval=presets.EvalConfig(out_hw=(40, 72), ds_hw=(20, 36)),
        extra={"layers": (1, 1, 1, 1)})


@pytest.fixture()
def tiny_cfg(tmp_path):
    gta = synthetic.make_gta5_fixture(str(tmp_path / "gta"), n=2, h=40, w=72)
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=2, h=40, w=72,
                                                 split="train")
    cfg = _tiny_warmup()
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, source_root=str(tmp_path / "gta"), source_list=gta,
        target_root=str(tmp_path / "city"), target_img_list=img, target_lbl_list=lbl))


def test_run_training_logs_what_to_device_steps_compute(tiny_cfg, tmp_path):
    state, step, _ = build_experiment(tiny_cfg, CPU)
    run_training(tiny_cfg, state, step, None, str(tmp_path / "wd"), CPU, log_every=1)
    with open(tmp_path / "wd" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [0, 1, 2]

    state, step, _ = build_experiment(tiny_cfg, CPU)
    it, loaders = make_train_iterator(tiny_cfg, wants_target(tiny_cfg))
    try:
        by_hand = []
        for _ in range(3):
            batch = to_device(next(it), CPU)
            batch.pop("t_lbl", None)
            by_hand.append({k: float(v) for k, v in step(state, batch).items()})
    finally:
        for ld in loaders:
            ld.stop()
    for rec, want in zip(logged, by_hand):
        assert {k: rec[k] for k in want} == want
