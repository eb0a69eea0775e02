#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (``samrs_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo
checkout; it has no CPU path and raises on any failure.  Phases:

1. prints the card's name and power limit (nvidia-smi) and builds the
   kernel library from samrs_tpu_torch/csrc (timed);
2. kernel phase: K1-K6 at the shapes of one ViT-H image and a 64-prompt
   bucket on seeded inputs, each compared with its plain PyTorch version run
   in fp32 on the same bf16-rounded inputs (relative L2 must stay <= 1e-2),
   and timed against the plain version in bf16 (CUDA events, median of 7);
   K2 also against ``F.scaled_dot_product_attention`` with the rel-pos bias
   as its mask; K5 also with 21 live tokens in 32 slots (two slot blocks,
   as a decode with many point prompts gives it).  K7 on 32 low-res masks
   to an 800x800 original (input 1024x1024) and to a 768x1024 original
   (input 768x1024): counts, boxes and bits must equal the plain version's
   except at pixels whose plain logit lies within 1e-4 of a threshold
   (counted and printed).  The plain versions round where the kernels
   round (bf16 products with fp32 epilogues, the online softmax's bf16
   probabilities), so the kernel and plain paths differ only in fp32
   summation order and the flips it causes.  Each kernel gets its bound:
   the larger of its bytes (each input read once, each output written once)
   over 3.35 TB/s and its flops over the peak of its type (989 TFLOP/s
   bf16 tensor cores, 67 TFLOP/s fp32);
3. main path: ViT-H with seeded random weights (zero-initialised parameters
   re-randomised), ``SamPredictor.set_image`` on a non-square 768x1024 image
   and ``predict_boxes`` on 64 boxes; checks shapes, finiteness and launches
   K1 28, K2 4, K3 32, K4 1, K5 2, K6 1 per image, then reruns on the plain
   versions (``Sam.use_kernels = False``): encoder feature rel-L2 <= 2e-2
   and mean mask IoU >= 0.99;
4. generate phase: a seeded 800x800 image and a DIOR XML with 100 boxes
   of 16-240 px, labels uniform over DIOR's 20 classes (bucket 256, four K7
   chunks), loaded with the port's DIOR loader and run through
   ``SemanticGenerator.process_image``; writes the pkl and PNGs to a
   temporary directory and reads them back; checks launches K1-K7
   28/4/32/1/2/1/4, that every RLE decodes to its recorded area, that the
   gray PNG is the label of the last instance covering each pixel and the
   colour PNG is PALETTE[gray], and against the plain path mean instance
   IoU, per-pixel cover-index agreement and gray agreement, each >= 0.99;
5. prints one JSON line of per-kernel results (launches from the generate
   phase), then the final status line.

``--profile`` adds a torch.profiler table of one warm generate image with
the kernels and with the plain versions (device time by kernel, device busy
share of the wall time).  ``chip_drift.py`` shows where the two paths part.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_BOXES = 64
IMAGE_HW = (768, 1024)
GEN_HW = (800, 800)
GEN_BOXES = 100
GEN_BOX_PX = (16, 240)  # box sides, uniform; not taken from a DIOR statistic
MAIN_LAUNCHES = {"K1": 28, "K2": 4, "K3": 32, "K4": 1, "K5": 2, "K6": 1, "K7": 0}
GEN_LAUNCHES = {"K1": 28, "K2": 4, "K3": 32, "K4": 1, "K5": 2, "K6": 1, "K7": 4}
KERNEL_RTOL = 1e-2     # bf16 rounding of operands / intermediates vs an fp32 reference
FEATURE_RTOL = 2e-2    # 32 blocks with bf16 products, kernels vs plain versions
IOU_MIN = 0.99         # kernels vs plain path: bf16 summation order flips pixels near 0
K7_NEAR = 1e-4         # K7 pixels this close to a threshold may flip (fp32 sum order)
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}


def counters():
    from samrs_tpu_torch.kernels import (amg_post, flash_attention, fused_mlp, fused_twoway,
                                         fused_upscale, fused_window_layer)
    return {"K1": (fused_window_layer, "launches"), "K2": (flash_attention, "launches"),
            "K3": (fused_mlp, "launches"), "K4": (fused_twoway, "kv_launches"),
            "K5": (fused_twoway, "i2t_launches"), "K6": (fused_upscale, "launches"),
            "K7": (amg_post, "launches")}


def reset_counts() -> None:
    for mod, name in counters().values():
        setattr(mod, name, 0)


def read_counts():
    return {k: getattr(mod, name) for k, (mod, name) in counters().items()}


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


def rel_l2(a, b) -> float:
    a = torch.cat([t.float().flatten() for t in a])
    b = torch.cat([t.float().flatten() for t in b])
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bound(nbytes: float, flops: float, peak: str):
    """(least ms for this work on an H100, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def kernel_phase(gen: torch.Generator):
    from samrs_tpu_torch.kernels import (flash_attention, fused_mlp, fused_twoway, fused_upscale,
                                         fused_window_layer)

    C, nH, ws, G = 1280, 16, 14, 64
    hd = C // nH
    T = G * G
    Bp, D, Ci, NTOK, NLIVE = 64, 256, 128, 16, 7  # decoder: prompts, widths, token slots

    def rn(*shape, std=1.0):  # bf16-representable fp32 values
        return (torch.randn(*shape, generator=gen, device="cuda") * std).bfloat16().float()

    cases = []  # key, title, source, replaces, kernel, fp32 reference, bf16 plain, bytes, flops, library
    xn = rn(1, G, G, C).bfloat16()
    k1 = (rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.5), rn(C, C, std=C ** -0.5),
          rn(C, std=0.1), rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1), ws, hd ** -0.5, nH)
    nwin = (-(-G // ws)) ** 2
    k1_flops = 2 * T * C * 4 * C + nwin * nH * (4 * (ws * ws) ** 2 * hd + 4 * ws ** 3 * hd)
    cases.append(("K1", "window layer", "samrs_tpu_torch/csrc/window_attention.cu",
                  "samrs_tpu/kernels/fused_window_layer.py:639",
                  lambda: fused_window_layer.window_layer_attention(xn, *k1),
                  lambda: fused_window_layer.window_layer_plain(xn.float(), *k1),
                  lambda: fused_window_layer.window_layer_plain(xn, *k1),
                  2 * (2 * T * C + 4 * C * C), k1_flops, None))
    qkv = rn(1, T, 3 * C).bfloat16()
    k2 = (rn(G, G, hd, std=0.1), rn(G, G, hd, std=0.1), (G, G), hd ** -0.5, nH)
    q, k, v = qkv.reshape(1, T, 3, nH, hd).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = flash_attention._rel_rows(q, k2[0], k2[1], (G, G))
    sdpa_mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(1, nH, T, T).bfloat16()
    del rel_h, rel_w
    cases.append(("K2", "global flash attention", "samrs_tpu_torch/csrc/flash_attention.cu",
                  "samrs_tpu/kernels/flash_attention.py:343",
                  lambda: flash_attention.attention_qkv_relpos(qkv, *k2),
                  lambda: flash_attention.attention_qkv_relpos_plain(qkv.float(), *k2),
                  lambda: flash_attention.attention_qkv_relpos_plain(qkv, *k2),
                  2 * 4 * T * C, 4 * nH * T * T * hd,
                  lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                         scale=hd ** -0.5)))
    x = rn(T, C)  # the encoder's fp32 residual stream
    k3 = (1.0 + rn(C, std=0.1), rn(C, std=0.1), rn(4 * C, C, std=C ** -0.5), rn(4 * C, std=0.1),
          rn(C, 4 * C, std=(4 * C) ** -0.5), rn(C, std=0.1), 1e-6)
    cases.append(("K3", "LN-MLP-residual", "samrs_tpu_torch/csrc/gemm.cu",
                  "samrs_tpu/kernels/fused_mlp.py:249",
                  lambda: fused_mlp.ln_mlp_residual(x, *k3),
                  lambda: fused_mlp.ln_mlp_residual_plain(x, *k3, dtype=torch.float32),
                  lambda: fused_mlp.ln_mlp_residual_plain(x, *k3, dtype=torch.bfloat16),
                  2 * 4 * T * C + 2 * 8 * C * C, 16 * T * C * C, None))

    # decoder image side at bucket 64: batch-1 keys (layer 0), per-prompt keys (layer 1)
    keys1, pe = rn(1, T, D), rn(T, D)
    keysB = rn(Bp, T, D)
    kvw = (rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1), rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1))
    cases.append(("K4", "decoder t2i K/V projection", "samrs_tpu_torch/csrc/twoway.cu",
                  "samrs_tpu/kernels/fused_twoway.py:192",
                  lambda: fused_twoway.t2i_kv_proj(keys1, pe, *kvw),
                  lambda: fused_twoway.t2i_kv_proj_plain(keys1, pe, *kvw, torch.float32),
                  lambda: fused_twoway.t2i_kv_proj_plain(keys1, pe, *kvw, torch.bfloat16),
                  2 * T * D * 4 + 2 * Ci * D * 2 + 2 * T * Ci * 2, 2 * 2 * T * D * Ci, None))
    def tokens(live, slots):  # token K, V and mask bias with `live` of `slots` slots live
        on = torch.arange(slots, device="cuda") < live
        return (rn(Bp, slots, Ci) * on[None, :, None], rn(Bp, slots, Ci) * on[None, :, None],
                torch.where(on, 0.0, -1e9))

    i2tw = (rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1), rn(D, Ci, std=Ci ** -0.5), rn(D, std=0.1),
            1.0 + rn(D, std=0.1), rn(D, std=0.1), rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1),
            rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1), 8)
    box_tokens = tokens(NLIVE, NTOK)
    for key, title, kin, out_dt, kin_bytes, (tok_k, tok_v, mask_bias) in (
            ("K5s", "decoder i2t update, shared keys", keys1, torch.float32, T * D * 4, box_tokens),
            ("K5p", "decoder i2t update, per-prompt keys", keysB, torch.bfloat16, Bp * T * D * 4,
             box_tokens),
            ("K5w", "decoder i2t update, 21 tokens in 32 slots", keysB, torch.float32,
             Bp * T * D * 4, tokens(21, 2 * NTOK))):
        S = tok_k.shape[1]
        row_flops = 2 * (D * Ci + 2 * S * Ci + Ci * D + 2 * D * Ci)
        small = 2 * Bp * S * Ci * 4 + 4 * Ci * D * 2
        args = (kin, pe, tok_k, tok_v, mask_bias, *i2tw)
        osz = 4 if out_dt == torch.float32 else 2
        cases.append((key, title, "samrs_tpu_torch/csrc/twoway.cu",
                      "samrs_tpu/kernels/fused_twoway.py:281",
                      lambda a=args, o=out_dt: fused_twoway.i2t_update(*a, out_dtype=o),
                      lambda a=args, o=out_dt: fused_twoway.i2t_update_plain(
                          *a, dtype=torch.float32, out_dtype=o),
                      lambda a=args, o=out_dt: fused_twoway.i2t_update_plain(
                          *a, dtype=torch.bfloat16, out_dtype=o),
                      kin_bytes + T * D * 4 + small + Bp * T * (D * osz + 2 * Ci * 2),
                      Bp * T * row_flops, None))
    src = rn(Bp, G, G, D).bfloat16()
    upw = (rn(D, D // 4, 2, 2, std=D ** -0.5), rn(D // 4, std=0.1), 1.0 + rn(D // 4, std=0.1),
           rn(D // 4, std=0.1), rn(D // 4, D // 8, 2, 2, std=(D // 4) ** -0.5), rn(D // 8, std=0.1))
    hyper = rn(Bp, 1, D // 8)
    cases.append(("K6", "upscaling + hypernetwork dot", "samrs_tpu_torch/csrc/upscale.cu",
                  "samrs_tpu/kernels/fused_upscale.py:153",
                  lambda: fused_upscale.upscale_hyper(src, *upw, hyper),
                  lambda: fused_upscale.upscale_hyper_plain(src.float(), *upw, hyper, torch.float32),
                  lambda: fused_upscale.upscale_hyper_plain(src, *upw, hyper, torch.bfloat16),
                  Bp * T * D * 2 + Bp * 16 * T * 4,
                  2 * Bp * T * (D * D + D * D // 2 + 16 * (D // 8)), None))

    results = {}
    for key, title, source, replaces, kernel, ref, plain, nbytes, flops, library in cases:
        got = as_tuple(kernel())
        torch.cuda.synchronize()
        want = as_tuple(ref())
        if [g.shape for g in got] != [w.shape for w in want]:
            raise RuntimeError(f"{key}: kernel gave {[tuple(g.shape) for g in got]}, "
                               f"plain {[tuple(w.shape) for w in want]}")
        err = rel_l2(got, want)
        max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        err_bf16 = rel_l2(got, as_tuple(plain()))
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(library) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops, "bf16")
        print(f"{key} {title}: rel_l2={err:.3e} max_abs={max_abs:.3e} "
              f"rel_l2_to_bf16_plain={err_bf16:.3e} kernel_ms={ms:.4f} "
              f"plain_bf16_ms={plain_ms:.4f} library_ms={lib_ms} bound_ms={bound_ms:.4f} "
              f"({bound_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"{key}: relative L2 {err:.3e} > {KERNEL_RTOL}")
        results[key] = dict(name=f"{key} {title}", route="cuda", source=source, replaces=replaces,
                            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms)
        del got, want
    del sdpa_mask, keysB, src
    torch.cuda.empty_cache()
    results.update(k7_phase(gen))
    # the kernel line lists K5 once: its layer-1 (per-prompt) launch, with the
    # shared-keys mode and the 32-slot case beside it
    k5 = results.pop("K5p")
    k5["name"] = ("K5 decoder i2t update (per-prompt keys; shared-keys mode in shared_*, "
                  "21 tokens in 32 slots in slots32_*)")
    for key, prefix in (("K5s", "shared"), ("K5w", "slots32")):
        other = results.pop(key)
        k5.update({f"{prefix}_{k}": other[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")})
        k5["max_abs_err"] = max(k5["max_abs_err"], other["max_abs_err"])
    results["K5"] = k5
    return {k: results[k] for k in sorted(results)}


def k7_phase(gen: torch.Generator):
    from samrs_tpu_torch.kernels import amg_post

    g, img_size, M, mt, off = 256, 1024, 32, 0.0, 1.0
    low = (torch.randn(M, g, g, generator=gen, device="cuda") * 4.0).contiguous()
    out = {}
    for inp, orig in (((1024, 1024), GEN_HW), (IMAGE_HW, IMAGE_HW)):
        run = lambda: amg_post.amg_postprocess(low, inp, orig, img_size, mt, off)
        plain = lambda: amg_post.amg_postprocess_plain(low, inp, orig, img_size, mt, off)
        hi, lo, boxes, packed = run()
        torch.cuda.synchronize()
        hi_p, lo_p, boxes_p, packed_p = plain()
        Ho, Wo = orig
        wy = torch.from_numpy(amg_post._composed_axis(g, img_size, inp[0], Ho)).cuda()
        wx = torch.from_numpy(amg_post._composed_axis(g, img_size, inp[1], Wo)).cuda()
        logits = (wy @ low) @ wx.T
        near = (logits - mt).abs() < K7_NEAR
        near_hi = ((logits - mt - off).abs() < K7_NEAR).sum((-1, -2))
        near_lo = ((logits - mt + off).abs() < K7_NEAR).sum((-1, -2))
        shifts = torch.arange(7, -1, -1, device="cuda", dtype=torch.uint8)
        unpack = lambda p: ((p[..., None] >> shifts) & 1).reshape(M, Ho, -1)[..., :Wo].bool()
        bits, bits_p = unpack(packed), unpack(packed_p)
        flips = int((bits != bits_p).sum())
        flips_far = int(((bits != bits_p) & ~near).sum())
        hi_ok = bool(((hi - hi_p).abs() <= near_hi).all())
        lo_ok = bool(((lo - lo_p).abs() <= near_lo).all())
        own_boxes = amg_post._boxes_from_masks(bits)
        box_diff = int((boxes - boxes_p).abs().max())
        max_abs = max(int((hi - hi_p).abs().max()), int((lo - lo_p).abs().max()), box_diff)
        print(f"K7 postprocess {inp}->{orig}: {int(near.sum())} pixels within {K7_NEAR} of the "
              f"threshold, {flips} bits differ ({flips_far} elsewhere), hi/lo within the near "
              f"counts {hi_ok}/{lo_ok}, max |box diff| {box_diff}", flush=True)
        if flips_far or not (hi_ok and lo_ok) or not torch.equal(boxes, own_boxes):
            raise RuntimeError(f"K7 {orig}: disagrees with its plain version")
        if box_diff and not near.any():
            raise RuntimeError(f"K7 {orig}: boxes differ with no pixel near the threshold")
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        # flops this data needs: the nonzero taps of both banded stages
        nnz_y = int((wy != 0).sum())
        nnz_x = int((wx != 0).sum())
        flops = M * 2 * (nnz_y * g + nnz_x * Ho)
        nbytes = M * g * g * 4 + packed.numel() + M * 6 * 4
        bound_ms, bound_by = bound(nbytes, flops, "fp32")
        print(f"K7 {orig}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
              f"({bound_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)", flush=True)
        out[orig] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    r = out[GEN_HW]
    return {"K7": dict(name="K7 full-resolution mask postprocess (32 masks to 800x800)",
                       route="cuda", source="samrs_tpu_torch/csrc/amg_post.cu",
                       replaces="samrs_tpu/kernels/amg_post.py:140", library_ms=None,
                       ms_768x1024=out[IMAGE_HW]["ms"], **r)}


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    inter = np.logical_and(a, b).sum(1)
    union = np.logical_or(a, b).sum(1)
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def build_model(gen: torch.Generator):
    from samrs_tpu_torch.sam import build_sam

    t0 = time.perf_counter()
    model = build_sam("vit_h", device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    print(f"built ViT-H with seeded weights in {time.perf_counter() - t0:.1f} s", flush=True)
    return model


def main_path(model):
    from samrs_tpu_torch.sam import SamPredictor

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

    model.use_kernels = True
    reset_counts()
    masks, iou, low = run()
    launches = read_counts()
    print(f"main path launches: {launches}", flush=True)
    if launches != MAIN_LAUNCHES:
        raise RuntimeError(f"launch counts {launches} != {MAIN_LAUNCHES} for one image")
    feats = predictor.features.clone()
    if masks.shape != (N_BOXES, 1, H, W) or masks.dtype != np.bool_:
        raise RuntimeError(f"masks {masks.shape} {masks.dtype}")
    g, d = model.cfg.grid_size, model.cfg.prompt_embed_dim
    if iou.shape != (N_BOXES, 1) or low.shape != (N_BOXES, 1, 4 * g, 4 * g):
        raise RuntimeError(f"iou {iou.shape}, low-res {low.shape}")
    if not (np.isfinite(iou).all() and np.isfinite(low).all() and torch.isfinite(feats).all()):
        raise RuntimeError("non-finite outputs on the kernel path")
    if tuple(feats.shape) != (1, g, g, d):
        raise RuntimeError(f"features {tuple(feats.shape)}")

    model.use_kernels = False
    masks_p, iou_p, _ = run()
    if read_counts() != launches:
        raise RuntimeError("the plain path launched a kernel")
    err = rel_l2([feats], [predictor.features])
    ious = mask_iou(masks, masks_p)
    print(f"kernels vs plain: feature rel_l2={err:.3e}, mask IoU mean={ious.mean():.5f} "
          f"min={ious.min():.5f}, |iou pred diff| max={np.abs(iou - iou_p).max():.3e}, "
          f"foreground share={masks.mean():.4f}", flush=True)
    if not err <= FEATURE_RTOL:
        raise RuntimeError(f"feature relative L2 {err:.3e} > {FEATURE_RTOL}")
    if not ious.mean() >= IOU_MIN:
        raise RuntimeError(f"mean mask IoU {ious.mean():.5f} < {IOU_MIN}")

    # img/s (set_image + 64-box predict_boxes), paths in turns, warm
    times = {True: [], False: []}
    for use_kernels in (True, False, False, True):
        model.use_kernels = use_kernels
        for _ in range(3):
            t = time.perf_counter()
            run()
            times[use_kernels].append(time.perf_counter() - t)
    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        print(f"img/s ({label}): {1.0 / statistics.median(times[use_kernels]):.3f}", flush=True)
    model.use_kernels = True
    return launches


def dior_xml(boxes: np.ndarray, names) -> str:
    objs = "".join(
        f"<object><name>{n}</name><bndbox><xmin>{b[0]:.1f}</xmin><ymin>{b[1]:.1f}</ymin>"
        f"<xmax>{b[2]:.1f}</xmax><ymax>{b[3]:.1f}</ymax></bndbox></object>"
        for b, n in zip(boxes, names))
    return f"<annotation>{objs}</annotation>"


def profile_image(run, model) -> None:
    """torch.profiler over one warm generate image per path: device time by
    kernel and the device's busy share of the wall time; then cProfile of
    the host side of one image with the kernels."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        model.use_kernels = use_kernels
        run()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA) / 1e3
        print(f"profile ({label}): wall {wall_ms:.2f} ms under the profiler, device "
              f"{device_ms:.2f} ms, busy {100 * device_ms / wall_ms:.1f}% of the profiled wall",
              flush=True)
        print(events.table(sort_by="self_device_time_total", row_limit=18, max_name_column_width=60),
              flush=True)
    model.use_kernels = True
    host = cProfile.Profile()
    host.runcall(run)
    pstats.Stats(host, stream=sys.stdout).sort_stats("tottime").print_stats(14)
    sys.stdout.flush()


def generate_scene(seed: int, box_px=GEN_BOX_PX):
    """A seeded 800x800 image and GEN_BOXES DIOR boxes with sides uniform in
    `box_px` and labels uniform over DIOR's 20 classes."""
    from samrs_tpu_torch.data.mapping import CLASS_SETS

    rng = np.random.default_rng(seed)
    H, W = GEN_HW
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    xy0 = rng.uniform(0, [W - box_px[0], H - box_px[0]], (GEN_BOXES, 2))
    wh = rng.uniform(box_px[0], box_px[1], (GEN_BOXES, 2))
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, [W - 1, H - 1])], 1)
    labels = rng.integers(0, len(CLASS_SETS["dior"]), GEN_BOXES)
    return image, boxes, labels


def cover_index(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (H, W) int: the last instance covering each pixel,
    -1 where none does (the generator's coverage fold)."""
    hit = masks.any(0)
    last = masks.shape[0] - 1 - masks[::-1].argmax(0)
    return np.where(hit, last, -1)


def generate_phase(model, profile: bool = False):
    from PIL import Image

    from samrs_tpu_torch.core.config import GenerateConfig
    from samrs_tpu_torch.data.loaders import load_dior
    from samrs_tpu_torch.data.mapping import CLASS_SETS, PALETTE
    from samrs_tpu_torch.data.rle import rle_decode
    from samrs_tpu_torch.data.writers import save_color_png, save_instances_pkl, save_semantic_png
    from samrs_tpu_torch.generate.semantic import SemanticGenerator
    from samrs_tpu_torch.sam import SamPredictor

    H, W = GEN_HW
    image, boxes, labels = generate_scene(SEED + 1)
    classes = CLASS_SETS["dior"]
    gen = SemanticGenerator(SamPredictor(model, buckets=GenerateConfig().box_buckets), classes)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "img0.xml"), "w") as f:
            f.write(dior_xml(boxes, [classes[i] for i in labels]))
        ann = load_dior("img0", tmp)
        if ann.num_instances != GEN_BOXES:
            raise RuntimeError(f"loader read {ann.num_instances} boxes")

        def run():
            res = gen.process_image(image, ann)
            torch.cuda.synchronize()
            return res

        model.use_kernels = True
        reset_counts()
        res = run()
        launches = read_counts()
        print(f"generate launches: {launches}", flush=True)
        if launches != GEN_LAUNCHES:
            raise RuntimeError(f"generate launch counts {launches} != {GEN_LAUNCHES}")
        paths = {k: os.path.join(tmp, f"img0_{k}.png") for k in ("gray", "color")}
        save_semantic_png(paths["gray"], res.gray)
        save_color_png(paths["color"], res.color)
        save_instances_pkl(os.path.join(tmp, "img0.pkl"), res.records)
        with Image.open(paths["gray"]) as im:
            gray = np.asarray(im)
        with Image.open(paths["color"]) as im:
            color = np.asarray(im)
        with open(os.path.join(tmp, "img0.pkl"), "rb") as f:
            records = pickle.load(f)
    if gray.shape != (H, W) or not np.array_equal(gray, res.gray):
        raise RuntimeError("gray PNG does not read back")
    if not np.array_equal(color, PALETTE[gray]):
        raise RuntimeError("color PNG is not PALETTE[gray]")
    if len(records) != GEN_BOXES or [r["label"] for r in records] != labels.tolist():
        raise RuntimeError("instance records do not match the annotation")
    masks = np.stack([rle_decode(r["mask"]) for r in records]).astype(bool)
    if masks.shape != (GEN_BOXES, H, W) or [int(m.sum()) for m in masks] != \
            [r["size"] for r in records]:
        raise RuntimeError("an RLE does not decode to its recorded area")
    cover = cover_index(masks)
    want_gray = np.where(cover >= 0, labels[np.maximum(cover, 0)], 255)
    if not np.array_equal(gray, want_gray):
        raise RuntimeError("gray PNG is not the label of the last instance covering each pixel")

    model.use_kernels = False
    res_p = run()
    if read_counts() != launches:
        raise RuntimeError("the plain path launched a kernel")
    masks_p = np.stack([rle_decode(r["mask"]) for r in res_p.records]).astype(bool)
    ious = mask_iou(masks, masks_p)
    cover_agree = float((cover == cover_index(masks_p)).mean())
    agree = float((res.gray == res_p.gray).mean())
    print(f"generate kernels vs plain: instance IoU mean={ious.mean():.5f} min={ious.min():.5f}, "
          f"cover agreement={cover_agree:.5f}, gray agreement={agree:.5f}, "
          f"covered share={(cover >= 0).mean():.4f}", flush=True)
    if not (ious.mean() >= IOU_MIN and cover_agree >= IOU_MIN and agree >= IOU_MIN):
        raise RuntimeError(f"generate: IoU {ious.mean():.5f} / cover agreement {cover_agree:.5f} "
                           f"/ gray agreement {agree:.5f} < {IOU_MIN}")

    times = {True: [], False: []}
    for use_kernels in (True, False, False, True):
        model.use_kernels = use_kernels
        t = time.perf_counter()
        run()
        times[use_kernels].append(time.perf_counter() - t)
    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        print(f"generate s/image ({label}, 800x800, 100 boxes): "
              f"{statistics.median(times[use_kernels]):.4f}", flush=True)
    if profile:
        profile_image(run, model)
    model.use_kernels = True
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true", help="profile one generate image per path")
    args = ap.parse_args()
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
    model = build_model(gen)
    main_launches = main_path(model)
    gen_launches = generate_phase(model, args.profile)
    for key, n in gen_launches.items():
        results[key]["launches"] = n
        results[key]["launches_main_path"] = main_launches[key]
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
