"""Build and bind the C RLE codec (``rle_ext.c``) with the host compiler.

The first call compiles ``rle_ext.c`` with the first of ``COMPILERS`` that
succeeds into ``samrs_tpu_torch/_build/librle_ext_<hash>.so`` (the hash is
of the source, so an edited source builds anew) and loads it with ctypes.
There is no fallback: a missing compiler or a failed build raises
``RuntimeError``, and the label generator stops rather than continue on a
slower codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

COMPILERS = ("cc", "gcc", "clang")
SOURCE = Path(__file__).resolve().with_name("rle_ext.c")
BUILD_DIR = SOURCE.parent.parent / "_build"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compile(so: Path) -> None:
    """Compile SOURCE into `so` (written under a temporary name, then
    renamed, so a concurrent build never loads a partial file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for cc in COMPILERS:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", tmp, str(SOURCE)],
                           check=True, capture_output=True, text=True)
        except FileNotFoundError:
            errors.append(f"{cc}: not found")
        except subprocess.CalledProcessError as e:
            errors.append(f"{cc}: exit {e.returncode}: {e.stderr.strip()}")
        else:
            os.replace(tmp, so)
            return
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    raise RuntimeError(f"cannot build the C RLE codec {SOURCE}: no compiler of "
                       f"{COMPILERS} built it ({'; '.join(errors)})")


def rle_library() -> ctypes.CDLL:
    """The codec's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
        so = BUILD_DIR / f"librle_ext_{tag}.so"
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        u8p, lp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long)
        lib.rle_encode_batch.restype = ctypes.c_long
        lib.rle_encode_batch.argtypes = [u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                                         u8p, ctypes.c_long, lp, lp]
        _lib = lib
        return lib


def encoded_bound(h: int, w: int) -> int:
    """Most bytes one h x w mask can encode to.  Of its R <= hw + 1 run
    counts each value x (a count, or a count less the one two before, so
    |x| <= the two counts' sum) takes ceil((bitlen + 1) / 5) <= 1 + |x| / 5
    characters, and the |x| sum to at most 2hw: at most hw + 1 + 2hw / 5
    bytes, 1.4 a pixel.  (The JAX package sized 4 bytes a pixel.)"""
    n = h * w
    return n + 2 + (2 * n) // 5


def native_rle_encode_batch(masks: np.ndarray) -> List[bytes]:
    """COCO compressed counts of (N, H, W) binary masks (bool or uint8), one
    C call for the batch.  The output buffer holds the bound of every mask;
    only the pages the encodings fill are touched."""
    masks = np.asarray(masks)
    if masks.ndim != 3:
        raise ValueError(f"masks: expected (N, H, W), got shape {masks.shape}")
    if masks.dtype == np.bool_:
        masks = masks.view(np.uint8)
    m = np.ascontiguousarray(masks, np.uint8)
    n, h, w = m.shape
    cap = max(n, 1) * encoded_bound(h, w)
    out = np.empty(cap, np.uint8)
    offsets = np.empty(n, np.int64)
    lengths = np.empty(n, np.int64)
    u8p, lp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long)
    total = rle_library().rle_encode_batch(
        m.ctypes.data_as(u8p), n, h, w, out.ctypes.data_as(u8p), cap,
        offsets.ctypes.data_as(lp), lengths.ctypes.data_as(lp))
    if total < 0:  # the bound above makes this unreachable
        raise RuntimeError(f"C RLE codec overflowed {cap} bytes for masks {m.shape}")
    return [out[o:o + k].tobytes() for o, k in zip(offsets.tolist(), lengths.tolist())]
