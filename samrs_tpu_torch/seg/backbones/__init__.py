"""Segmentation backbones of the port (ported so far: the RVSA ViTs)."""
