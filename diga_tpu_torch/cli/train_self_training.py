"""Self-training stage trainer (reference train_DiGA_*_self_training.py).

python -m diga_tpu_torch.cli.train_self_training --preset gta2city_selftrain \
    --load_weight_dir ./work_dir/warmup/weights \
    --centroid_path ./work_dir/centroids/feat_centroids.npy \
    --pseudo_dir pseudo_train_warm_up ...
"""

from .train_seg import main as _main


def main(argv=None):
    return _main(argv, force_stage="selftrain")


if __name__ == "__main__":
    main()
