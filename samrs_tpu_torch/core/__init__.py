"""Configuration of the PyTorch port."""

from samrs_tpu_torch.core.config import SAM_VARIANTS, GenerateConfig, SamConfig, sam_config

__all__ = ["SAM_VARIANTS", "GenerateConfig", "SamConfig", "sam_config"]
