from uig_torch.config.config import (
    Config,
    DataConfig,
    EvalConfig,
    LossConfig,
    ModelConfig,
    OptConfig,
    ParallelConfig,
    RunConfig,
    apply_overrides,
    config_from_dict,
    config_to_dict,
    load_config,
)
from uig_torch.config.presets import PRESETS, get_preset

__all__ = [
    "Config",
    "DataConfig",
    "EvalConfig",
    "LossConfig",
    "ModelConfig",
    "OptConfig",
    "ParallelConfig",
    "RunConfig",
    "PRESETS",
    "get_preset",
    "apply_overrides",
    "config_from_dict",
    "config_to_dict",
    "load_config",
]
