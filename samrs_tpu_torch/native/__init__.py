"""Native (C) host components, built with the host compiler at first use and
bound with ctypes: the COCO RLE codec of the label generator."""

from samrs_tpu_torch.native.build import native_rle_encode_batch, rle_library

__all__ = ["native_rle_encode_batch", "rle_library"]
