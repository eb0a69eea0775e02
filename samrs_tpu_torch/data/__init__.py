"""Host-side data of the port (numpy and PIL only): the label generator's
annotation loaders, label constants, COCO RLE and label writers, and the
pretraining dataset, augmentation and loader."""
