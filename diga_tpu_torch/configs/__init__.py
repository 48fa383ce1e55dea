from .presets import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    LoaderSpec,
    PRESETS,
    TrainConfig,
    get_preset,
)
