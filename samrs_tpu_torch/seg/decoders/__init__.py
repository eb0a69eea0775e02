"""Segmentation decoders of the port (ported so far: UperNet)."""
