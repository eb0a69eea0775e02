#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (``samrs_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo
checkout; it has no CPU path and raises on any failure.  Phases:

1. prints the card's name and power limit (nvidia-smi) and builds the
   kernel library from samrs_tpu_torch/csrc (timed);
2. kernel phase: K1, K2 and K3 at the ViT-H shapes of one 1024^2 image on
   seeded bf16 inputs, each compared with its plain PyTorch version run in
   fp32 on the same bf16-rounded inputs (relative L2 must stay <= 1e-2),
   and timed against the plain version in bf16 (CUDA events, median of 7);
3. main path: ViT-H with seeded random weights (zero-initialised parameters
   re-randomised), ``SamPredictor.set_image`` on a non-square 768x1024 image
   and ``predict_boxes`` on 64 boxes; checks output shapes and finiteness,
   that the kernels launched 28 (K1), 4 (K2) and 32 (K3) times, then reruns
   the path on the plain versions and bounds the feature difference;
4. prints one JSON line of per-kernel results, then the final status line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_BOXES = 64
IMAGE_HW = (768, 1024)
EXPECTED_LAUNCHES = {"K1": 28, "K2": 4, "K3": 32}
KERNEL_RTOL = 1e-2     # bf16 rounding of qkv / P / hidden / outputs vs an fp32 reference
FEATURE_RTOL = 2e-2    # 32 bf16 blocks, kernels vs plain versions, both in bf16


def cuda_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def kernel_phase(gen: torch.Generator):
    from samrs_tpu_torch.kernels import flash_attention, fused_mlp, fused_window_layer

    C, nH, ws, G = 1280, 16, 14, 64
    hd = C // nH

    def rn(*shape, std=1.0):  # bf16-representable fp32 values
        return (torch.randn(*shape, generator=gen, device="cuda") * std).bfloat16().float()

    cases = []
    xn = rn(1, G, G, C).bfloat16()
    k1 = (rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.5), rn(C, C, std=C ** -0.5),
          rn(C, std=0.1), rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1), ws, hd ** -0.5, nH)
    cases.append(("K1", "window layer", "samrs_tpu_torch/csrc/window_attention.cu",
                  "samrs_tpu/kernels/fused_window_layer.py:639",
                  lambda: fused_window_layer.window_layer_attention(xn, *k1),
                  lambda x: fused_window_layer.window_layer_plain(x, *k1), xn))
    qkv = rn(1, G * G, 3 * C).bfloat16()
    k2 = (rn(G, G, hd, std=0.1), rn(G, G, hd, std=0.1), (G, G), hd ** -0.5, nH)
    cases.append(("K2", "global flash attention", "samrs_tpu_torch/csrc/flash_attention.cu",
                  "samrs_tpu/kernels/flash_attention.py:343",
                  lambda: flash_attention.attention_qkv_relpos(qkv, *k2),
                  lambda x: flash_attention.attention_qkv_relpos_plain(x, *k2), qkv))
    x = rn(G * G, C).bfloat16()
    k3 = (1.0 + rn(C, std=0.1), rn(C, std=0.1), rn(4 * C, C, std=C ** -0.5), rn(4 * C, std=0.1),
          rn(C, 4 * C, std=(4 * C) ** -0.5), rn(C, std=0.1), 1e-6)
    cases.append(("K3", "LN-MLP-residual", "samrs_tpu_torch/csrc/gemm.cu",
                  "samrs_tpu/kernels/fused_mlp.py:249",
                  lambda: fused_mlp.ln_mlp_residual(x, *k3),
                  lambda t: fused_mlp.ln_mlp_residual_plain(t, *k3), x))

    results = {}
    for key, title, source, replaces, kernel, plain, inp in cases:
        got = kernel()
        torch.cuda.synchronize()
        ref = plain(inp.float())
        if got.shape != ref.shape or got.dtype != torch.bfloat16:
            raise RuntimeError(f"{key}: kernel gave {tuple(got.shape)} {got.dtype}, "
                               f"plain {tuple(ref.shape)}")
        err = rel_l2(got, ref)
        max_abs = float((got.float() - ref).abs().max())
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: plain(inp))
        print(f"{key} {title}: rel_l2={err:.3e} max_abs={max_abs:.3e} "
              f"kernel_ms={ms:.3f} plain_bf16_ms={plain_ms:.3f}", flush=True)
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"{key}: relative L2 {err:.3e} > {KERNEL_RTOL}")
        results[key] = dict(name=f"{key} {title}", route="cuda", source=source, replaces=replaces,
                            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return results


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    inter = np.logical_and(a, b).sum(1)
    union = np.logical_or(a, b).sum(1)
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def main_path(gen: torch.Generator):
    from samrs_tpu_torch.kernels import flash_attention, fused_mlp, fused_window_layer
    from samrs_tpu_torch.sam import SamPredictor, build_sam

    modules = {"K1": fused_window_layer, "K2": flash_attention, "K3": fused_mlp}
    t0 = time.perf_counter()
    model = build_sam("vit_h", device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    print(f"built ViT-H with seeded weights in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(SEED)
    H, W = IMAGE_HW
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    xy0 = rng.uniform([0, 0], [W - 64, H - 64], (N_BOXES, 2))
    wh = rng.uniform(32, 320, (N_BOXES, 2))
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, [W - 1, H - 1])], 1).astype(np.float32)
    predictor = SamPredictor(model)

    def run():
        predictor.set_image(image)
        out = predictor.predict_boxes(boxes)
        torch.cuda.synchronize()
        return out

    for m in modules.values():
        m.launches = 0
    masks, iou, low = run()
    launches = {k: m.launches for k, m in modules.items()}
    print(f"main path launches: {launches}", flush=True)
    if launches != EXPECTED_LAUNCHES:
        raise RuntimeError(f"launch counts {launches} != {EXPECTED_LAUNCHES} for one image")
    feats = predictor.features.clone()
    if masks.shape != (N_BOXES, 1, H, W) or masks.dtype != np.bool_:
        raise RuntimeError(f"masks {masks.shape} {masks.dtype}")
    if iou.shape != (N_BOXES, 1) or low.shape != (N_BOXES, 1, 256, 256):
        raise RuntimeError(f"iou {iou.shape}, low-res {low.shape}")
    if not (np.isfinite(iou).all() and np.isfinite(low).all() and torch.isfinite(feats).all()):
        raise RuntimeError("non-finite outputs on the kernel path")
    if tuple(feats.shape) != (1, 64, 64, 256):
        raise RuntimeError(f"features {tuple(feats.shape)}")

    model.image_encoder.use_kernels = False
    masks_p, iou_p, _ = run()
    if any(m.launches != launches[k] for k, m in modules.items()):
        raise RuntimeError("the plain path launched a kernel")
    err = rel_l2(feats, predictor.features)
    ious = mask_iou(masks, masks_p)
    print(f"kernels vs plain: feature rel_l2={err:.3e}, mask IoU mean={ious.mean():.5f} "
          f"min={ious.min():.5f}, |iou pred diff| max={np.abs(iou - iou_p).max():.3e}, "
          f"foreground share={masks.mean():.4f}", flush=True)
    if not err <= FEATURE_RTOL:
        raise RuntimeError(f"feature relative L2 {err:.3e} > {FEATURE_RTOL}")

    # img/s (set_image + 64-box predict_boxes), paths in turns, warm
    times = {True: [], False: []}
    for use_kernels in (True, False, False, True):
        model.image_encoder.use_kernels = use_kernels
        for _ in range(3):
            t = time.perf_counter()
            run()
            times[use_kernels].append(time.perf_counter() - t)
    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        print(f"img/s ({label}): {1.0 / statistics.median(times[use_kernels]):.3f}", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this script runs on a GPU only")
    from samrs_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s)",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = kernel_phase(gen)
    launches = main_path(gen)
    for key, n in launches.items():
        results[key]["launches"] = n
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
