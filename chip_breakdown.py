#!/usr/bin/env python3
"""Where the time of K1's attention stage and of K5 goes, on one CUDA card,
by timing variants of their sources with one stage switched off.

    python3 chip_breakdown.py --csrc DIR

DIR is a ``samrs_tpu_torch/csrc``: this tree's (the wgmma K1 attention
stage and K5) or that of a tree before their Hopper redesign (the
one-block-per-(window, head, image) mma.sync K1 and the
one-block-per-64-row-tile cp.async K5; unpack it with ``git archive`` into a
directory that ``.gitignore`` lists).  The script copies
window_attention.cu and twoway.cu into variants in which a stage is switched
off at run time (a condition the compiler cannot fold: the work is skipped,
the rest of the code stays), builds each with nvcc for sm_90a, and times
each at the main path's shapes (ViT-H: one 64 x 64 x 3840 qkv map, 16 heads
of 80; the decoder at bucket 64: 64 prompts x 4096 rows, 16 token slots):
the old kernels by direct calls, 20 back-to-back launches between CUDA
events, median of 5; the new ones through the wrappers with the variant's
library swapped in, torch.profiler's device time per kernel.  The
differences between variants are the stages' shares; a stage that overlaps
another shows less than it costs alone.  The new kernels are timed at K1's
attention stage in the fused2 and ijb orders, on partitioned windows and on
a 70 x 70 map (no window pads), and at K5 per-prompt and shared; the full
variant also by the wall time of 20 back-to-back calls (the wrappers' host
work included), and its registers and spills (ptxas) are printed.  It
checks nothing and prints one JSON line of ms per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from samrs_tpu_torch.kernels import _build

OFF = "(samrs_prof_off != 0)"  # false at run time; the compiler cannot fold it
GUARD = "__device__ int samrs_prof_off;  // 0: the stages it guards are skipped\n"

# variant -> the (old, new) substitutions made in its source
K1_VARIANTS = {
    "full": [],
    "no_rel": [("if (t < NT) {", f"if (t < NT && {OFF}) {{")],
    "no_products": [("for (int k0 = 0; k0 < L.np; k0 += 64) {",
                     f"for (int k0 = 0; k0 < ({OFF} ? L.np : 0); k0 += 64) {{")],
    "loads_stores": [("if (t < NT) {", f"if (t < NT && {OFF}) {{"),
                     ("for (int k0 = 0; k0 < L.np; k0 += 64) {",
                      f"for (int k0 = 0; k0 < ({OFF} ? L.np : 0); k0 += 64) {{")],
}
K5_ATTN = ("for (int sb = 0; sb < nslot / NTOK; ++sb) {",
           f"for (int sb = 0; sb < ({OFF} ? nslot / NTOK : 0); ++sb) {{")
K5_PROJ = ("warp_gemm<", f"if {OFF} warp_gemm<")
K5_WLOAD = ("load_rows_async<THREADS>(Ws,", f"if {OFF} load_rows_async<THREADS>(Ws,")
K5_VARIANTS = {
    "full": [],
    "no_attention": [K5_ATTN],
    "no_products": [K5_PROJ],
    "no_weight_loads": [K5_WLOAD],
    "tile_io_and_layernorm": [K5_ATTN, K5_PROJ, K5_WLOAD],
}


# the same for the Hopper kernels (window_wgmma_kernel, i2t_wgmma_kernel)
K1_NEW_VARIANTS = {
    "full": [],
    "loads_only": [("for (int u = lo; u < hi; ++u) {",
                    f"for (int u = lo; u < ({OFF} ? hi : lo); ++u) {{")],
    "no_s": [("for (int kk = 0; kk < 4; ++kk) wgmma_ss_n200(",
              f"for (int kk = 0; kk < ({OFF} ? 4 : 0); ++kk) wgmma_ss_n200(")],
    "no_bias": [("v = fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[WIN + kc - kx * WIN]);",
                 f"v = {OFF} ? fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[WIN + kc - kx * WIN])"
                 " : sacc[4 * j + e] * scale;")],
    "no_pv": [("for (int kk = 0; kk < NPV / 16; ++kk) {",
               f"for (int kk = 0; kk < ({OFF} ? NPV / 16 : 0); ++kk) {{")],
}
K5_NEW_VARIANTS = {
    "full": [],
    "no_attention": [K5_ATTN],
    "no_projections": [("    if constexpr (NW == 128) wgmma_rs_n128(acc, af[kk], db, kk != 0);\n"
                        "    else wgmma_rs_n64(acc, af[kk], db, kk != 0);",
                        f"    if constexpr (NW == 128) {{ if {OFF} "
                        "wgmma_rs_n128(acc, af[kk], db, kk != 0); }\n"
                        f"    else {{ if {OFF} wgmma_rs_n64(acc, af[kk], db, kk != 0); }}")],
}


def variant_source(src: Path, subs, dst: Path) -> None:
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{src.name}: '{old}' not found: not the kernel this script profiles")
        text = text.replace(old, new)
    marker = "namespace samrs {\nnamespace {\n"
    if subs and marker not in text:
        raise SystemExit(f"{src.name}: no anonymous namespace to put the guard in")
    dst.write_text(text.replace(marker, marker + GUARD, 1) if subs else text)


def is_hopper(csrc: Path) -> bool:
    """Whether `csrc` holds the wgmma K1 / K5 (else the mma.sync / cp.async ones)."""
    return "window_wgmma_kernel" in (csrc / "window_attention.cu").read_text()


def build(csrc: Path, out: Path):
    """Builds every variant into its own shared library; returns
    {(kernel, variant): CDLL} and the nvcc logs under the same keys."""
    if out.exists():
        shutil.rmtree(out)
    jobs = []
    new = is_hopper(csrc)
    for kernel, fname, variants in (
            ("K1", "window_attention.cu", K1_NEW_VARIANTS if new else K1_VARIANTS),
            ("K5", "twoway.cu", K5_NEW_VARIANTS if new else K5_VARIANTS)):
        for name, subs in variants.items():
            d = out / f"{kernel}_{name}"
            shutil.copytree(csrc, d)
            variant_source(csrc / fname, subs, d / fname)
            lib = d / "lib.so"
            jobs.append(((kernel, name), lib, [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                                               "-o", str(lib), str(d / fname)]))
    procs = [(key, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)) for key, lib, cmd in jobs]
    libs, logs = {}, {}
    for key, lib, p in procs:
        logs[key] = log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib = ctypes.CDLL(str(lib))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
    return libs, logs


def loop_ms(fn, n: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def call(lib, name: str, *args) -> None:
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = _build._SIGNATURES[name]
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def device_ms(fn, n: int = 20):
    """torch.profiler's device time per call of each kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            m = re.search(r"\w+_kernel(<\d+>)?", e.key)
            out[m.group(0) if m else e.key[:48]] = e.self_device_time_total / 1e3 / n
    return out


def wrapper_cases():
    """The main path's K1 attention stage and K5 calls through the wrappers."""
    from samrs_tpu_torch.kernels import (fused_attention, fused_twoway, fused_window_block,
                                         fused_window_layer)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    C, nH, hd, G, ws = 1280, 16, 80, 64, 14
    qkv, bqkv = rn(1, G, G, 3 * C).bfloat16(), rn(3 * C, std=0.5)
    Rh, Rw = rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1)
    qkv_win = rn(25, ws * ws, 3 * C).bfloat16()  # the 25 windows of the padded map, partitioned
    qkv70 = rn(1, 70, 70, 3 * C).bfloat16()  # the same windows on a map that needs no pad
    Bp, N, D, Ci, S = 64, G * G, 256, 128, 16
    keysB, keys1, pe = rn(Bp, N, D), rn(1, N, D), rn(N, D)
    tok = (rn(Bp, S, Ci), rn(Bp, S, Ci), torch.where(torch.arange(S, device="cuda") < 7, 0.0, -1e9))
    w = (rn(Ci, D, std=D ** -0.5), rn(Ci), rn(D, Ci, std=Ci ** -0.5), rn(D), 1 + rn(D, std=0.1),
         rn(D), rn(Ci, D, std=D ** -0.5), rn(Ci), rn(Ci, D, std=D ** -0.5), rn(Ci), 8)
    cases = {
        "K1 fused2": lambda: fused_window_block.window_attention_partition_free(
            qkv, Rh, Rw, ws, hd ** -0.5, nH, pad_fill=bqkv),
        "K1 ijb stage": lambda: fused_window_layer.window_attention_cuda(
            qkv, bqkv, Rh, Rw, ws, hd ** -0.5, nH, order="ijb"),
        "K1 fused windows": lambda: fused_attention.attention_qkv_fused(
            qkv_win, Rh, Rw, (ws, ws), hd ** -0.5, nH),
        "K1 fused2 70x70": lambda: fused_window_block.window_attention_partition_free(
            qkv70, Rh, Rw, ws, hd ** -0.5, nH, pad_fill=bqkv),
        "K5 per-prompt": lambda: fused_twoway.i2t_update(keysB, pe, *tok, *w,
                                                         out_dtype=torch.bfloat16),
        "K5 shared": lambda: fused_twoway.i2t_update(keys1, pe, *tok, *w),
    }
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the csrc directory of the tree whose kernels are profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_breakdown.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs, logs = build(args.csrc.resolve(), _build.BUILD_DIR / "breakdown")
    if is_hopper(args.csrc.resolve()):  # the wrappers' calls, each variant's library swapped in
        results = {}
        for case, fn in wrapper_cases().items():
            kernel = case.split()[0]
            for (k, name), lib in libs.items():
                if k != kernel:
                    continue
                _build._lib = lib
                results[f"{case} {name}"] = device_ms(fn)
                if name == "full":  # and the whole call, host work included
                    results[f"{case} {name}"]["wall"] = loop_ms(fn)
                print(f"{case} {name}: " + ", ".join(f"{a} {b:.4f}" for a, b in
                                                    results[f"{case} {name}"].items()), flush=True)
        _build._lib = None
        for key in (("K1", "full"), ("K5", "full")):  # registers, spills, shared memory
            lines = logs[key].splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "_kernel" in line:
                    print("\n".join(x.strip() for x in lines[i:i + 4]), flush=True)
        print(json.dumps({"device": smi, "ms": results}), flush=True)
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr

    # K1's attention stage: one ViT-H image, 64 x 64 map, 16 heads of 80 (pads to 70 x 70)
    C, nH, hd, G, ws = 1280, 16, 80, 64, 14
    qkv, bqkv = rn(1, G, G, 3 * C).bfloat16(), rn(3 * C, std=0.5).bfloat16()
    rh, rw = rn(ws, hd, ws, std=0.1), rn(ws, hd, ws, std=0.1)
    out = torch.empty(1, G, G, C, device="cuda", dtype=torch.bfloat16)
    results = {}
    for order, label in ((1, "ijb"), (0, "plain")):
        for name in K1_VARIANTS:
            lib = libs[("K1", name)]
            results[f"K1 {label} {name}"] = loop_ms(lambda: call(
                lib, "samrs_window_attention", p(qkv), p(bqkv), p(rh), p(rw), p(out), 1, G, G, G,
                G, C, nH, hd, ws, 0, order, hd ** -0.5))

    # K5 at bucket 64: per-prompt keys with a bf16 keys2 (layer 1) and shared keys (layer 0)
    Bp, N, D, Ci, S = 64, G * G, 256, 128, 16
    keysB, keys1, pe = rn(Bp, N, D), rn(1, N, D), rn(N, D)
    tok_k, tok_v = rn(Bp, S, Ci), rn(Bp, S, Ci)
    mask = torch.where(torch.arange(S, device="cuda") < 7, 0.0, -1e9)
    wq, wo, wk, wv = (rn(Ci, D, std=D ** -0.5).bfloat16(), rn(D, Ci, std=Ci ** -0.5).bfloat16(),
                      rn(Ci, D, std=D ** -0.5).bfloat16(), rn(Ci, D, std=D ** -0.5).bfloat16())
    bq, bo, g4, b4, bk, bv = rn(Ci), rn(D), 1 + rn(D, std=0.1), rn(D), rn(Ci), rn(Ci)
    k_out = torch.empty(Bp, N, Ci, device="cuda", dtype=torch.bfloat16)
    v_out = torch.empty_like(k_out)
    for label, keys, out_bf16 in (("per-prompt", keysB, 1), ("shared", keys1, 0)):
        keys2 = torch.empty(Bp, N, D, device="cuda",
                            dtype=torch.bfloat16 if out_bf16 else torch.float32)
        for name in K5_VARIANTS:
            lib = libs[("K5", name)]
            results[f"K5 {label} {name}"] = loop_ms(lambda: call(
                lib, "samrs_i2t_update", p(keys), p(pe), p(tok_k), p(tok_v), p(mask), p(wq),
                p(bq), p(wo), p(bo), p(g4), p(b4), p(wk), p(bk), p(wv), p(bv), p(keys2),
                p(k_out), p(v_out), Bp, N, S, int(keys.shape[0] == 1), out_bf16, 0.25, 1e-5))
    for k, v in results.items():
        print(f"{k}: {v:.4f} ms", flush=True)
    print(json.dumps({"device": smi, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
