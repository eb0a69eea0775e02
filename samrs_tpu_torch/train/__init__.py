"""Segmentation training and testing of the port: optimizer, trainer core and
the ``python -m samrs_tpu_torch.train.pretrain`` (SEP pretraining),
``...train.finetune`` (finetuning) and ``...train.evaluate`` (sliding-window
test) entry points."""
