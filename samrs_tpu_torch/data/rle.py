"""COCO run-length encoding of binary masks (the port's copy of
samrs_tpu/data/rle.py).  The byte format is pycocotools': column-major runs
starting with a zero run, then delta + 5-bit varint characters offset by
48, so the instance pkls read back with pycocotools.  ``rle_encode_batch``
(the label generator's) encodes with the C codec of
``samrs_tpu_torch.native``; ``rle_encode`` is the numpy codec, its oracle.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

RLE = Dict[str, Union[List[int], bytes, str]]


def _mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary (H, W) mask -> COCO run counts (column-major, zero run first)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat.size and flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def _counts_to_mask(counts: Sequence[int], size: Tuple[int, int]) -> np.ndarray:
    h, w = size
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[: h * w].reshape((h, w), order="F")


def _encode_counts(counts: Sequence[int]) -> bytes:
    """COCO compressed counts string: each count (from the fourth on, less
    the count two before it) as little-endian 5-bit groups, bit 0x20 on
    every group but the last, plus 48.  A value takes the fewest groups that
    hold it as a signed integer, so the group count follows from its signed
    bit length; all characters are formed at once."""
    c = np.asarray(counts, np.int64)
    x = c.copy()
    x[3:] -= c[1:-2]
    mag = np.where(x < 0, ~x, x)
    n = (np.frexp(mag.astype(np.float64))[1] + 5) // 5  # bits incl. sign, in 5-bit groups
    idx = np.repeat(np.arange(x.size), n)
    k = np.arange(idx.size) - np.repeat(np.cumsum(n) - n, n)
    chars = (x[idx] >> (5 * k)) & 0x1F | np.where(k < n[idx] - 1, 0x20, 0)
    return (chars + 48).astype(np.uint8).tobytes()


def _decode_counts(s: Union[bytes, str]) -> np.ndarray:
    """Inverse of ``_encode_counts``, all characters at once: a value ends at
    a character without 0x20; its groups are summed little-endian and
    sign-extended from the last group's 0x10 bit; then each count from the
    fourth on adds the count two before it (a running sum per parity)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    c = np.frombuffer(s, np.uint8).astype(np.int64) - 48
    if c.size == 0:
        return np.zeros(0, np.int64)
    ends = np.flatnonzero((c & 0x20) == 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    n = ends - starts + 1
    k = np.arange(c.size) - np.repeat(starts, n)
    x = np.add.reduceat((c & 0x1F) << (5 * k), starts)
    x = np.where(c[ends] & 0x10, x - (1 << (5 * n)), x)
    x[1::2] = np.cumsum(x[1::2])
    x[2::2] = np.cumsum(x[2::2])
    return x


def rle_encode(mask: np.ndarray) -> RLE:
    """Binary (H, W) mask -> compressed COCO RLE dict (maskUtils.encode)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _encode_counts(_mask_to_counts(mask))}


def rle_encode_batch(masks: np.ndarray) -> List[RLE]:
    """Binary (N, H, W) masks -> N compressed COCO RLE dicts, one call of the
    C codec (built at first use; raises if it cannot be built)."""
    from samrs_tpu_torch.native import native_rle_encode_batch

    _, h, w = masks.shape
    return [{"size": [int(h), int(w)], "counts": c} for c in native_rle_encode_batch(masks)]


def rle_decode(rle: RLE) -> np.ndarray:
    """Compressed or uncompressed RLE dict -> binary (H, W) uint8 mask."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_counts(counts)
    return _counts_to_mask(counts, tuple(rle["size"]))
