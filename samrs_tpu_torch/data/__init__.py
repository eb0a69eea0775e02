"""Annotation loaders, label constants, COCO RLE and label writers of the
port's generate driver (numpy only)."""
