"""SAM model, weight bridge, predictor and automatic mask generator of the PyTorch port."""

from samrs_tpu_torch.sam.api import sam_forward_batched
from samrs_tpu_torch.sam.automatic_mask_generator import SamAutomaticMaskGenerator
from samrs_tpu_torch.sam.build import build_sam, sam_model_registry
from samrs_tpu_torch.sam.predictor import SamPredictor
from samrs_tpu_torch.sam.sam import Sam

__all__ = ["Sam", "SamAutomaticMaskGenerator", "SamPredictor", "build_sam", "sam_forward_batched",
           "sam_model_registry"]
