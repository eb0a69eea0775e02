"""Segmentation models of the port: backbones, decoders, frameworks and the
weight bridge from the JAX package's variables."""
