"""PyTorch + CUDA port of samrs-tpu's SAM box-prompted generation path.

Mirrors the layout of ``samrs_tpu``: ``core`` (config), ``kernels`` (the
hand-written Hopper kernels and their plain PyTorch versions), ``nn``
(layers), ``sam`` (model, weight bridge, predictor).  Imports torch and numpy
only.
"""
