"""Build and load the port's CUDA kernels.

On first use, every ``samrs_tpu_torch/csrc/*.cu`` is compiled with nvcc for
``sm_90a`` (one nvcc process per source, all started together) and linked
into one shared library with a plain C interface under
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "samrs_error_string": ([_I], ctypes.c_char_p),
    "samrs_gemm_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "samrs_layernorm": ([_P, _P, _P, _P, _I, _I, _F, _P], _I),
    "samrs_layernorm_tail": ([_P] * 6 + [_I] * 6 + [_F, _P], _I),
    "samrs_window_attention_smem": ([_I], ctypes.c_longlong),
    "samrs_window_attention": ([_P] * 6 + [_I] * 11 + [_F, _P], _I),
    "samrs_flash_attention_relpos": ([_P] * 4 + [_I] * 7 + [_F, _I, _P], _I),
    "samrs_relpos_rows": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "samrs_split_attention_window": ([_P] * 6 + [_I] * 5 + [_F, _P], _I),
    "samrs_split_attention_tiled": ([_P] * 6 + [_I] * 5 + [_F, _P], _I),
    "samrs_split_window_rel": ([_P] * 5 + [_I, _I, _P], _I),
    "samrs_split_relpos_rows": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "samrs_t2i_kv": ([_P] * 8 + [_I, _I, _P], _I),
    "samrs_i2t_update": ([_P] * 18 + [_I, _I, _I, _I, _I, _F, _F, _P], _I),
    "samrs_upscale_hyper": ([_P] * 9 + [_I, _I, _I, _I, _F, _P], _I),
    "samrs_amg_post": ([_P] * 7 + [_I] * 5 + [_F, _F, _P], _I),
    "samrs_bilinear_fwd": ([_P] * 5 + [_I] * 7 + [_P], _I),
    "samrs_bilinear_bwd": ([_P] * 10 + [_I] * 7 + [_P], _I),
    "samrs_bilinear_slab_fwd": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "samrs_bilinear_slab_bwd": ([_P] * 9 + [_I] * 8 + [_P], _I),
    "samrs_point_sample_fwd": ([_P] * 4 + [_I] * 8 + [_P], _I),
    "samrs_point_sample_bwd": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "samrs_plain_attention_scratch_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "samrs_plain_attention": ([_P] * 4 + [ctypes.c_longlong, _P, _I, _I, _I, _F, _P], _I),
    "samrs_fused_mlp": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "samrs_tf32_split": ([_P, _P, _P, ctypes.c_longlong, _P], _I),
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


def _run_all(cmds):
    """Run the commands in parallel; returns (returncode, log) per command."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [" ".join(c) + "\n" + p.communicate()[0] for c, p in zip(cmds, procs)]
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def _compile(out: Path, srcs) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    t0 = time.perf_counter()
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
    if all(code == 0 for code, _ in results):
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        results += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    (BUILD_DIR / "build.log").write_text("\n".join(log for _, log in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [log for code, log in results if code != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
