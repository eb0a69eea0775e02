"""SEP segmentation pretraining of the port: optimizer, trainer core and the
``python -m samrs_tpu_torch.train.pretrain`` entry point."""
