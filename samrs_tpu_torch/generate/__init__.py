"""Label generation: detection annotations + SAM -> SAMRS semantic PNGs and
instance pkls, one image at a time (``python -m samrs_tpu_torch.generate.semantic``)
or on every local card with batched encodes and overlapped host IO
(``python -m samrs_tpu_torch.generate.fleet``); the HRSC prompt-type
evaluation (``python -m samrs_tpu_torch.generate.instance_eval``)."""

from samrs_tpu_torch.generate.fleet import run_fleet
from samrs_tpu_torch.generate.instance_eval import run_prompt_eval
from samrs_tpu_torch.generate.painter import paint_semantic, paint_semantic_device
from samrs_tpu_torch.generate.semantic import SemanticGenerator, generate_semantic

__all__ = ["SemanticGenerator", "generate_semantic", "paint_semantic", "paint_semantic_device",
           "run_fleet", "run_prompt_eval"]
