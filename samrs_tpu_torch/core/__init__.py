"""Configuration of the PyTorch port."""

from samrs_tpu_torch.core.config import (SAM_VARIANTS, DataConfig, GenerateConfig, OptimConfig,
                                         PretrainConfig, SamConfig, sam_config)

__all__ = ["SAM_VARIANTS", "DataConfig", "GenerateConfig", "OptimConfig", "PretrainConfig",
           "SamConfig", "sam_config"]
