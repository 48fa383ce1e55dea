"""Warm-up stage trainer (reference train_DiGA_*_warm_up.py).

python -m diga_tpu_torch.cli.train_warm_up --preset gta2city_warmup ...
"""

from .train_seg import main as _main


def main(argv=None):
    return _main(argv, force_stage="warmup")


if __name__ == "__main__":
    main()
