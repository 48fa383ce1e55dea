"""``cli/make_viz.py`` against ``diga_tpu.cli.make_viz`` (CPU, host only).

* ``colormap_to_label``, ``segm_edges``, ``make_figure`` and
  ``blend_frame`` give JAX's arrays; ``_load_pred`` reads the exact
  basename first, then the reference's naming, and inverts a colour
  render, as JAX's does;
* ``figure`` writes the same files as JAX's CLI on the same fixture, each
  decoding to equal pixels (with a label column, edges, a resize, 16
  classes), and refuses lists of unequal length;
* ``video`` writes one MJPG frame per image (needs OpenCV).
"""

import os

import numpy as np
import pytest
from PIL import Image

from diga_tpu.cli import make_viz as jax_make_viz
from diga_tpu_torch.cli import make_viz
from diga_tpu_torch.data.label_maps import (CITYSCAPES_COLORS_19, SYNTHIA_COLORS_16,
                                            decode_segmap, make_png_palette)


def _fixture(tmp_path, n=2, h=24, w=32, ncls=19):
    """Images, trainId predictions (plain, palette and colour-rendered, under
    both namings) and labels, with their lists."""
    rng = np.random.default_rng(0)
    img_root, lbl_root = tmp_path / "imgs", tmp_path / "lbls"
    preds = {k: tmp_path / k for k in ("plain", "palette", "colour")}
    for d in (img_root, lbl_root, *preds.values()):
        d.mkdir()
    names, lbls = [], []
    colors = SYNTHIA_COLORS_16 if ncls == 16 else CITYSCAPES_COLORS_19
    for i in range(n):
        rel = f"frame_{i:03d}.jpg"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(img_root / rel)
        pred = rng.integers(0, ncls, (h, w)).astype(np.uint8)
        Image.fromarray(pred).save(preds["plain"] / f"frame_{i:03d}.png")  # basename, .png
        pal = Image.fromarray(pred).convert("P")
        pal.putpalette(make_png_palette(colors))
        pal.save(preds["palette"] / rel, format="PNG")  # the reference naming: the basename
        Image.fromarray((decode_segmap(pred, colors) * 255).astype(np.uint8)).save(
            preds["colour"] / f"frame_{i:03d}.png")
        lbl = rng.integers(0, ncls, (h, w)).astype(np.uint8)
        Image.fromarray(lbl).save(lbl_root / f"lbl_{i:03d}.png")
        names.append(rel)
        lbls.append(f"lbl_{i:03d}.png")
    img_list, lbl_list = tmp_path / "list.txt", tmp_path / "lbl.txt"
    img_list.write_text("".join(f"{x}\n" for x in names))
    lbl_list.write_text("".join(f"{x}\n" for x in lbls))
    return {"img_root": str(img_root), "lbl_root": str(lbl_root), "img_list": str(img_list),
            "lbl_list": str(lbl_list), **{k: str(v) for k, v in preds.items()}}


def test_colormap_to_label_and_segm_edges_equal_jax():
    rng = np.random.default_rng(1)
    for colors in (CITYSCAPES_COLORS_19, SYNTHIA_COLORS_16):
        lbl = rng.integers(0, len(colors), (17, 23)).astype(np.uint8)
        rgb = (decode_segmap(lbl, colors) * 255).astype(np.uint8)
        rgb[0, :5] = (1, 2, 3)  # unmatched -> 255
        got = make_viz.colormap_to_label(rgb, colors)
        np.testing.assert_array_equal(got, jax_make_viz.colormap_to_label(rgb, colors))
        np.testing.assert_array_equal(got[1:], lbl[1:])
        assert (got[0, :5] == 255).all()
        np.testing.assert_array_equal(make_viz.segm_edges(lbl), jax_make_viz.segm_edges(lbl))


def test_make_figure_and_blend_frame_equal_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (13, 19, 3), dtype=np.uint8)
    cols = [rng.integers(0, 256, (13, 19, 3), dtype=np.uint8) for _ in range(3)]
    for pad in (0, 4):
        np.testing.assert_array_equal(make_viz.make_figure(img, cols, pad),
                                      jax_make_viz.make_figure(img, cols, pad))
    for alpha in (0.0, 0.55, 1.0):
        np.testing.assert_array_equal(make_viz.blend_frame(img, cols[0], alpha),
                                      jax_make_viz.blend_frame(img, cols[0], alpha))


@pytest.mark.parametrize("kind", ["plain", "palette", "colour"])
@pytest.mark.parametrize("size_wh", [None, (40, 30)])
def test_load_pred_equal_jax(tmp_path, kind, size_wh):
    fx = _fixture(tmp_path)
    for rel in ("frame_000.jpg", "sub/frame_001.jpg"):
        got = make_viz._load_pred(fx[kind], rel, size_wh)
        np.testing.assert_array_equal(got, jax_make_viz._load_pred(fx[kind], rel, size_wh))
        assert got.dtype == np.uint8
    np.testing.assert_array_equal(make_viz._load_pred(fx["plain"], "frame_000.jpg"),
                                  make_viz._load_pred(fx["colour"], "frame_000.jpg"))
    with pytest.raises(FileNotFoundError):
        make_viz._load_pred(fx[kind], "missing.jpg")


@pytest.mark.parametrize("extra", [[], ["--edges"], ["--size", "40", "30"],
                                   ["--lbl_list", "LBL", "--lbl_root", "LROOT", "--edges"]])
def test_figure_cli_writes_jax_figures(tmp_path, extra):
    fx = _fixture(tmp_path)
    extra = [{"LBL": fx["lbl_list"], "LROOT": fx["lbl_root"]}.get(a, a) for a in extra]
    argv = ["figure", "--img_root", fx["img_root"], "--img_list", fx["img_list"],
            "--pred_dirs", fx["plain"], fx["palette"], fx["colour"], *extra]
    make_viz.main([*argv, "--out_dir", str(tmp_path / "port")])
    jax_make_viz.main([*argv, "--out_dir", str(tmp_path / "jax")])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 2
    for f in files:
        got = np.asarray(Image.open(tmp_path / "port" / f))
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax" / f)))
        assert got.shape[1] > 3 * got.shape[0]  # the image and at least three columns


def test_figure_cli_16_classes_and_unequal_lists(tmp_path):
    fx = _fixture(tmp_path, ncls=16)
    argv = ["figure", "--img_root", fx["img_root"], "--img_list", fx["img_list"],
            "--pred_dirs", fx["colour"], "--num_classes", "16", "--limit", "1"]
    make_viz.main([*argv, "--out_dir", str(tmp_path / "port")])
    jax_make_viz.main([*argv, "--out_dir", str(tmp_path / "jax")])
    (f,) = os.listdir(tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / f)),
                                  np.asarray(Image.open(tmp_path / "jax" / f)))
    short = tmp_path / "short.txt"
    short.write_text("lbl_000.png\n")
    with pytest.raises(ValueError, match="pair positionally"):
        make_viz.main(["figure", "--img_root", fx["img_root"], "--img_list", fx["img_list"],
                       "--pred_dirs", fx["plain"], "--lbl_list", str(short),
                       "--lbl_root", fx["lbl_root"], "--out_dir", str(tmp_path / "x")])


@pytest.mark.parametrize("mode", ["blend", "side"])
def test_video_cli_frame_count(tmp_path, mode):
    cv2 = pytest.importorskip("cv2")
    fx = _fixture(tmp_path, n=3)
    out = str(tmp_path / "demo.avi")
    make_viz.main(["video", "--img_root", fx["img_root"], "--img_list", fx["img_list"],
                   "--pred_dirs", fx["plain"], "--out", out, "--mode", mode])
    cap = cv2.VideoCapture(out)
    try:
        assert cap.isOpened() and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
        assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(17.0)
        ok, frame = cap.read()
        assert ok and frame.shape == (24, 32 * (2 if mode == "side" else 1), 3)
    finally:
        cap.release()
