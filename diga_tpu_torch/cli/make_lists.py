"""Generate the plain-text file lists the loaders read.

The port's own copy of ``diga_tpu/cli/make_lists.py`` (:22-84).  The
loaders read one relative path per line, the reference's ``*_list/*.txt``
format, so the reference's shipped lists work as they are (its
semi-supervised labeled/unlabeled splits are benchmark definitions and not
derivable).  This tool regenerates the derivable ones by walking a
dataset directory; it needs no device:

  python -m diga_tpu_torch.cli.make_lists cityscapes --root ./data/Cityscapes --out lists/
  python -m diga_tpu_torch.cli.make_lists gta5 --root ./data/GTA5 --out lists/
  python -m diga_tpu_torch.cli.make_lists synthia --root ./data/SYNTHIA --out lists/
  python -m diga_tpu_torch.cli.make_lists bdd100k --root ./data/BDD100k --out lists/
  python -m diga_tpu_torch.cli.make_lists mapillary --root ./data/Mapillary --out lists/
"""

from __future__ import annotations

import argparse
import os


def _walk(root: str, subdir: str, exts=(".png", ".jpg")) -> list[str]:
    base = os.path.join(root, subdir)
    out = []
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(os.path.relpath(os.path.join(dirpath, f), base))
    return sorted(out)


def cityscapes_lists(root: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "val"):
        imgs = _walk(root, f"leftImg8bit/{split}")
        lbls = [i.replace("_leftImg8bit.png", "_gtFine_labelIds.png") for i in imgs]
        with open(os.path.join(out_dir, f"cityscapes_{split}.txt"), "w") as f:
            f.write("\n".join(imgs) + "\n")
        with open(os.path.join(out_dir, f"cityscapes_{split}_label.txt"), "w") as f:
            f.write("\n".join(lbls) + "\n")
        print(f"cityscapes {split}: {len(imgs)} images")


def flat_lists(root: str, out_dir: str, name: str, img_sub: str):
    os.makedirs(out_dir, exist_ok=True)
    imgs = _walk(root, img_sub)
    with open(os.path.join(out_dir, f"{name}_train.txt"), "w") as f:
        f.write("\n".join(imgs) + "\n")
    print(f"{name}: {len(imgs)} images")


def bare_id_lists(root: str, out_dir: str, name: str, img_sub: str, split: str):
    """BDD100k/Mapillary val lists in the reference's bare-id format
    (no extension; the loaders expand the path templates —
    BDDLoader.py:66-67, MapillaryLoader.py:165-166)."""
    os.makedirs(out_dir, exist_ok=True)
    ids = [os.path.splitext(p)[0] for p in _walk(root, img_sub, (".jpg", ".png"))]
    for suffix in ("", "_label"):
        with open(os.path.join(out_dir, f"{name}_{split}{suffix}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    print(f"{name} {split}: {len(ids)} images")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=["cityscapes", "gta5", "synthia",
                                       "bdd100k", "mapillary"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.dataset == "cityscapes":
        cityscapes_lists(args.root, args.out)
    elif args.dataset == "gta5":
        flat_lists(args.root, args.out, "gta5", "images")
    elif args.dataset == "bdd100k":
        bare_id_lists(args.root, args.out, "bdd100k", "images/val", "val")
    elif args.dataset == "mapillary":
        bare_id_lists(args.root, args.out, "mapillary", "validation/images", "val")
    else:
        flat_lists(args.root, args.out, "synthia", "RGB")


if __name__ == "__main__":
    main()
