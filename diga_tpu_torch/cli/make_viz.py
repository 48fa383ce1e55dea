"""Offline result visualization: comparison figures + demo videos.

The port's own copy of ``diga_tpu/cli/make_viz.py``, the counterpart of
the reference's offline tooling
(domain_adaptation/GTA5/util/data_visualization.py — figs_paper:92,
video_suppl_material:186, label2colormap:298, colormaps2label:318,
compute_segm_edges:237).  A host-only tool: it reads PNGs and writes
PNGs or a video, and uses no device (so it has no ``--device``).  Two
subcommands:

  figure  — side-by-side composites: input image | GT (optional) | one
            column per prediction dir (trainId or palette PNGs), saved
            as one PNG per image.
  video   — ordered frames -> demo video (cv2 VideoWriter MJPG .avi,
            like the reference :230-235), each frame an image/prediction
            blend or side-by-side pair.

Predictions are read as written by cli/pseudolabel_generator or
cli/evaluate_val --dump_preds: single-channel trainId PNGs or P-mode
palette PNGs (both decode to trainIds via PIL); a colour render is
inverted through the palette.  The colours are ``data/label_maps``'s
``decode_segmap``, the tiles ``utils/visualize.py``'s ``label_rgb``.

Usage:
  python -m diga_tpu_torch.cli.make_viz figure --img_root data/Cityscapes \
      --img_list lists/cityscapes_val.txt --pred_dirs runs/warm/preds runs/st/preds \
      --lbl_root data/Cityscapes --lbl_list lists/cityscapes_val_label.txt \
      --out_dir figs --limit 20
  python -m diga_tpu_torch.cli.make_viz video --img_root demo/frames \
      --img_list demo/list.txt --pred_dirs runs/st/preds --out demo.avi --mode blend
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from ..data.label_maps import CITYSCAPES_COLORS_19, SYNTHIA_COLORS_16
from ..utils.visualize import label_rgb


def colormap_to_label(rgb: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """Inverse of decode_segmap: color image -> trainId map (unmatched
    pixels -> 255).  reference: data_visualization.py:318-323."""
    rgb = np.asarray(rgb, dtype=np.int64)
    out = np.full(rgb.shape[:2], 255, dtype=np.uint8)
    for i, c in enumerate(np.asarray(colors, dtype=np.int64)):
        out[(rgb == c).all(axis=-1)] = i
    return out


def segm_edges(label: np.ndarray) -> np.ndarray:
    """Boolean class-boundary mask (4-neighborhood difference).

    reference: data_visualization.py:237-258 (edge extraction for the
    edge-overlay figures).
    """
    lbl = np.asarray(label)
    edge = np.zeros(lbl.shape, bool)
    edge[1:, :] |= lbl[1:, :] != lbl[:-1, :]
    edge[:, 1:] |= lbl[:, 1:] != lbl[:, :-1]
    return edge


def _read_lines(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip().split()[0] for ln in f if ln.strip()]


def _load_image(root: str, rel: str, size_wh=None) -> np.ndarray:
    img = Image.open(os.path.join(root, rel)).convert("RGB")
    if size_wh is not None:
        img = img.resize(size_wh, Image.BILINEAR)
    return np.asarray(img, np.uint8)


def _load_pred(pred_dir: str, rel: str, size_wh=None,
               colors=CITYSCAPES_COLORS_19) -> np.ndarray:
    """TrainId map from a prediction dir; tries the exact basename first,
    then the reference's pseudo-label naming (basename as-is, .png).
    ``colors`` is the palette used to invert color-rendered predictions."""
    base = os.path.splitext(os.path.basename(rel))[0]
    for cand in (os.path.join(pred_dir, base + ".png"),
                 os.path.join(pred_dir, os.path.basename(rel))):
        if os.path.exists(cand):
            img = Image.open(cand)
            if size_wh is not None:
                img = img.resize(size_wh, Image.NEAREST)
            arr = np.asarray(img)
            if arr.ndim == 3:  # color render -> invert
                return colormap_to_label(arr[..., :3], colors)
            return arr.astype(np.uint8)
    raise FileNotFoundError(f"no prediction for {rel} under {pred_dir}")


def _colorize(lbl: np.ndarray, colors) -> np.ndarray:
    return (label_rgb(lbl, colors) * 255).astype(np.uint8)


def make_figure(img: np.ndarray, columns: list[np.ndarray], pad: int = 4) -> np.ndarray:
    h, w = img.shape[:2]
    cols = [img] + columns
    out = np.full((h, len(cols) * (w + pad) - pad, 3), 255, np.uint8)
    for i, c in enumerate(cols):
        out[:, i * (w + pad): i * (w + pad) + w] = c
    return out


def blend_frame(img: np.ndarray, pred_rgb: np.ndarray, alpha: float = 0.55) -> np.ndarray:
    return (img.astype(np.float64) * (1 - alpha)
            + pred_rgb.astype(np.float64) * alpha).astype(np.uint8)


def run_figure(args) -> list[str]:
    names = _read_lines(args.img_list)[: args.limit or None]
    lbl_names = _read_lines(args.lbl_list)[: args.limit or None] if args.lbl_list else None
    if lbl_names is not None and len(lbl_names) != len(names):
        raise ValueError(
            f"--lbl_list has {len(lbl_names)} entries but --img_list has "
            f"{len(names)}: the lists pair positionally, so unequal lengths "
            "would mispair (or crash on) labels")
    colors = SYNTHIA_COLORS_16 if args.num_classes == 16 else CITYSCAPES_COLORS_19
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    size = tuple(args.size) if args.size else None
    for i, rel in enumerate(names):
        img = _load_image(args.img_root, rel, size)
        wh = (img.shape[1], img.shape[0])
        cols = []
        if lbl_names is not None:
            lbl = np.asarray(Image.open(os.path.join(args.lbl_root or args.img_root,
                                                     lbl_names[i])).resize(wh, Image.NEAREST))
            cols.append(_colorize(lbl, colors))
        for pd in args.pred_dirs:
            pred = _load_pred(pd, rel, wh, colors)
            rgb = _colorize(pred, colors)
            if args.edges:
                rgb = rgb.copy()
                rgb[segm_edges(pred)] = 255
            cols.append(rgb)
        fig = make_figure(img, cols)
        out = os.path.join(args.out_dir,
                           os.path.splitext(os.path.basename(rel))[0] + "_cmp.png")
        Image.fromarray(fig).save(out)
        written.append(out)
    print(f"wrote {len(written)} figures to {args.out_dir}")
    return written


def run_video(args) -> str:
    import cv2

    names = _read_lines(args.img_list)[: args.limit or None]
    colors = SYNTHIA_COLORS_16 if args.num_classes == 16 else CITYSCAPES_COLORS_19
    size = tuple(args.size) if args.size else None
    writer = None
    for rel in names:
        img = _load_image(args.img_root, rel, size)
        wh = (img.shape[1], img.shape[0])
        pred = _load_pred(args.pred_dirs[0], rel, wh, colors)
        rgb = _colorize(pred, colors)
        if args.mode == "blend":
            frame = blend_frame(img, rgb)
        else:  # side-by-side, like the reference supplementary video
            frame = np.concatenate([img, rgb], axis=1)
        if writer is None:
            writer = cv2.VideoWriter(
                args.out, cv2.VideoWriter_fourcc(*"MJPG"), args.fps,
                (frame.shape[1], frame.shape[0]))
            if not writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter failed to open {args.out}")
        writer.write(frame[..., ::-1])  # RGB -> BGR
    if writer is not None:
        writer.release()
    print(f"wrote {len(names)} frames to {args.out}")
    return args.out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--img_root", required=True)
        sp.add_argument("--img_list", required=True)
        sp.add_argument("--pred_dirs", nargs="+", required=True)
        sp.add_argument("--num_classes", type=int, default=19)
        sp.add_argument("--limit", type=int, default=0)
        sp.add_argument("--size", type=int, nargs=2, default=None,
                        metavar=("W", "H"))

    f = sub.add_parser("figure", help="side-by-side comparison figures")
    common(f)
    f.add_argument("--lbl_root", default=None)
    f.add_argument("--lbl_list", default=None)
    f.add_argument("--out_dir", required=True)
    f.add_argument("--edges", action="store_true",
                   help="overlay white class-boundary edges on predictions")

    v = sub.add_parser("video", help="demo video from ordered frames")
    common(v)
    v.add_argument("--out", required=True, help="output .avi path (MJPG)")
    v.add_argument("--fps", type=float, default=17.0)  # reference :230
    v.add_argument("--mode", choices=["blend", "side"], default="blend")

    args = p.parse_args(argv)
    if args.cmd == "figure":
        run_figure(args)
    else:
        run_video(args)


if __name__ == "__main__":
    main()
