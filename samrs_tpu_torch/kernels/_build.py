"""Build and load the port's CUDA kernels.

On first use, every ``samrs_tpu_torch/csrc/*.cu`` is compiled with nvcc for
``sm_90a`` into one shared library with a plain C interface under
``samrs_tpu_torch/_build/`` (named by a hash of the sources, so an edited
source rebuilds), and loaded with ctypes.  Nothing here runs at import time:
the CPU path of every wrapper never reaches this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "samrs_error_string": ([_I], ctypes.c_char_p),
    "samrs_gemm_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "samrs_layernorm_bf16": ([_P, _P, _P, _P, _I, _I, _F, _P], _I),
    "samrs_window_attention_smem": ([_I], ctypes.c_longlong),
    "samrs_window_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "samrs_flash_attention_relpos": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
}

_lib = None
build_seconds = None  # wall time of the build in this process (None if loaded from disk)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cannot build the CUDA kernels: nvcc not found "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha1()
    for p in srcs + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return srcs, digest.hexdigest()[:16]


def _compile(out: Path, srcs) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Raises if CUDA is
    unavailable, nvcc is missing, or the build or load fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
    srcs, tag = _sources()
    path = BUILD_DIR / f"libsamrs_kernels_{tag}.so"
    if not path.exists():
        _compile(path, srcs)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load the kernel library {path}: {e}") from e
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def ptr(t):
    """Device pointer of a tensor (NULL for None)."""
    return None if t is None else t.data_ptr()


def launch(name: str, *args) -> None:
    """Call C entry point `name` with `args` plus the current stream, and
    raise if it reports a CUDA error (e.g. a refused launch)."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.samrs_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
