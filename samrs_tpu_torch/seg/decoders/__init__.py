"""Segmentation decoders of the port (ported so far: UperNet, Mask2Former)."""
