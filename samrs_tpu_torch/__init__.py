"""PyTorch + CUDA port of samrs-tpu: SAM box-prompted label generation and
SEP segmentation pretraining.

Mirrors the layout of ``samrs_tpu``: ``core`` (configs, metrics,
checkpoints), ``kernels`` (the hand-written Hopper kernels and their plain
PyTorch versions), ``nn`` (layers), ``sam`` (model, weight bridge,
predictor), ``generate`` (the label generator), ``seg`` (backbones,
decoders, frameworks, weight bridge), ``data`` and ``train`` (the pretrain
entry point).  Imports torch, numpy and PIL only.
"""
