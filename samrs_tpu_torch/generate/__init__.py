"""Label generation: detection annotations + SAM -> SAMRS semantic PNGs and
instance pkls (``python -m samrs_tpu_torch.generate.semantic``)."""
