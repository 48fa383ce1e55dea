"""Domain-generalization trainer (reference train_DiGA_DG.py).

python -m diga_tpu_torch.cli.train_dg --preset dg_gta5 ...
"""

from .train_seg import main as _main


def main(argv=None):
    return _main(argv, force_stage="dg")


if __name__ == "__main__":
    main()
