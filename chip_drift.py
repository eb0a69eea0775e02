#!/usr/bin/env python3
"""Where the kernel path and the plain path of the port part, on one CUDA card.

    python3 chip_drift.py

Information only: it checks nothing.  It prints

0. K1 stage by stage (qkv GEMM, window attention, proj GEMM) against its
   plain version on the same seeded inputs: relative L2 and the share of
   bf16 outputs that differ;

and, with a seeded ViT-H built as chip_smoke.py builds it,

1. on the main-path image (768x1024), the encoder features through the
   kernels (K), through the plain versions in bf16 (P) and in fp32 on the
   card (F), and through P with one of K1, K2, K3 swapped in; the relative
   L2 distance of each pair to K, P and F, and block by block of K and P;
2. on chip_smoke.py's generate scene (boxes of 16-240 px) and on the same
   scene drawn with boxes of 12-96 px: mean and least instance IoU,
   per-pixel cover-index agreement and gray agreement of K against P, and of
   K's features decoded by P's decoder on the card and by the fp32 decoder
   on the host CPU.
"""

from __future__ import annotations

import contextlib
import copy
import time

import numpy as np
import torch

import chip_smoke as smoke


@contextlib.contextmanager
def patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


@torch.no_grad()
def encode(model, x, mode: str, trace=None):
    """Encoder features (1, 64, 64, 256) fp32 in `mode`: K, P, F, or P with
    one kernel swapped in (K1, K2, K3).  `trace` collects block outputs."""
    from samrs_tpu_torch.kernels import flash_attention as fa
    from samrs_tpu_torch.kernels import fused_mlp as fm
    from samrs_tpu_torch.kernels import fused_window_layer as fw
    from samrs_tpu_torch.sam import image_encoder

    enc = model.image_encoder
    plain = {"K1": dict(fw=fw.window_layer_plain), "K2": dict(fa=fa.attention_qkv_relpos_plain),
             "K3": dict(fm=fm.ln_mlp_residual_plain)}
    hooks = [] if trace is None else [
        blk.register_forward_hook(lambda m, i, o: trace.append(o.float().clone()))
        for blk in enc.blocks]
    try:
        with contextlib.ExitStack() as stack:
            if mode == "F":
                stack.enter_context(patched(image_encoder, _compute_dtype=lambda t: torch.float32))
            if mode in plain:  # K with the two other kernels on their plain versions
                swapped = {k: v for key, p in plain.items() if key != mode for k, v in p.items()}
                if "fw" in swapped:
                    stack.enter_context(patched(fw, window_layer_attention=swapped["fw"]))
                if "fa" in swapped:
                    stack.enter_context(patched(fa, attention_qkv_relpos=swapped["fa"]))
                if "fm" in swapped:
                    stack.enter_context(patched(fm, ln_mlp_residual=swapped["fm"]))
            out = enc(x, use_kernels=mode not in ("P", "F")).float()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return out


def k1_stages() -> None:
    from samrs_tpu_torch.kernels import fused_window_layer as fw
    from samrs_tpu_torch.kernels import gemm

    g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    C, nH, ws, G = 1280, 16, 14, 64
    hd = C // nH

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).bfloat16().float()

    xn = rn(G * G, C).bfloat16()
    Wqkv, bqkv = rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.5)
    Wproj, bproj = rn(C, C, std=C ** -0.5), rn(C, std=0.1)
    Rh, Rw = rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1)
    att = (Rh, Rw, ws, hd ** -0.5, nH)
    qkv = gemm.linear(xn, Wqkv, bqkv)
    stages = {"qkv GEMM": (qkv, gemm.linear_plain(xn, Wqkv, bqkv))}
    qmap = qkv.reshape(1, G, G, 3 * C)
    attn = fw.window_attention_cuda(qmap, bqkv, *att)
    stages["window attention, 64x64 map"] = (attn, fw.window_attention_plain(qmap, bqkv, *att))
    inner = qmap[:, :56, :56].contiguous()  # 4x4 whole windows, no map padding
    stages["window attention, 56x56 map"] = (fw.window_attention_cuda(inner, bqkv, *att),
                                             fw.window_attention_plain(inner, bqkv, *att))
    a2 = attn.reshape(-1, C)
    stages["proj GEMM"] = (gemm.linear(a2, Wproj, bproj), gemm.linear_plain(a2, Wproj, bproj))
    layer = (xn.reshape(1, G, G, C), Wqkv, bqkv, Wproj, bproj, *att)
    whole_p = fw.window_layer_plain(*layer)
    stages["whole layer"] = (fw.window_layer_cuda(*layer), whole_p)
    qkv_p = stages["qkv GEMM"][1].reshape(1, G, G, 3 * C)
    mixed = gemm.linear(fw.window_attention_cuda(qkv_p, bqkv, *att).reshape(-1, C), Wproj, bproj)
    stages["whole layer, the plain qkv into the kernels"] = (mixed.reshape(whole_p.shape), whole_p)
    for name, (k, p) in stages.items():
        differ = (k.float() != p.float()).float().mean()
        print(f"K1 {name}: rel_l2 {smoke.rel_l2([k], [p]):.3e}, {float(differ):.2e} of the "
              f"bf16 values differ", flush=True)


def encoder_drift(model) -> None:
    from samrs_tpu_torch.sam.sam import preprocess
    from samrs_tpu_torch.sam.transforms import ResizeLongestSide

    cfg = model.cfg
    rng = np.random.default_rng(smoke.SEED)
    image = rng.integers(0, 256, (*smoke.IMAGE_HW, 3), dtype=np.uint8)
    resized = np.ascontiguousarray(ResizeLongestSide(cfg.image_size).apply_image(image))
    x = preprocess(torch.from_numpy(resized).cuda()[None], cfg.pixel_mean, cfg.pixel_std,
                   cfg.image_size)
    trace_k, trace_p = [], []
    feats = {"K": encode(model, x, "K", trace_k), "P": encode(model, x, "P", trace_p)}
    for mode in ("F", "K1", "K2", "K3"):
        feats[mode] = encode(model, x, mode)
    for mode, f in feats.items():
        print(f"encoder {mode}: rel_l2 to K {smoke.rel_l2([f], [feats['K']]):.3e}, "
              f"to P {smoke.rel_l2([f], [feats['P']]):.3e}, "
              f"to F {smoke.rel_l2([f], [feats['F']]):.3e}", flush=True)
    per_block = [smoke.rel_l2([a], [b]) for a, b in zip(trace_k, trace_p)]
    print("encoder K vs P by block: " + " ".join(f"{e:.2e}" for e in per_block), flush=True)


def masks_of(res) -> np.ndarray:
    from samrs_tpu_torch.data.rle import rle_decode

    return np.stack([rle_decode(r["mask"]) for r in res.records]).astype(bool)


def generate_drift(model) -> None:
    from samrs_tpu_torch.core.config import GenerateConfig
    from samrs_tpu_torch.data.loaders import Annotation
    from samrs_tpu_torch.data.mapping import CLASS_SETS
    from samrs_tpu_torch.generate.semantic import SemanticGenerator
    from samrs_tpu_torch.sam import SamPredictor

    classes = CLASS_SETS["dior"]
    buckets = GenerateConfig().box_buckets
    gen = SemanticGenerator(SamPredictor(model, buckets=buckets), classes)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_gen = SemanticGenerator(SamPredictor(cpu_model, buckets=buckets), classes)
    for box_px in (smoke.GEN_BOX_PX, (12, 96)):
        image, boxes, labels = smoke.generate_scene(smoke.SEED + 1, box_px)
        ann = Annotation(hboxes=np.round(boxes, 1).astype(np.float32),
                         labels=labels.astype(np.int32))
        model.use_kernels = True
        res = gen.process_image(image, ann)
        pred = gen.predictor
        encoded = (pred.features.clone(), pred.original_size, pred.input_size)
        model.use_kernels = False
        others = {"plain path": gen.process_image(image, ann),
                  "plain decoder, K's features": gen.process_encoded(encoded, smoke.GEN_HW, ann)}
        t = time.perf_counter()
        others["fp32 decoder on the CPU, K's features"] = cpu_gen.process_encoded(
            (encoded[0].cpu(), encoded[1], encoded[2]), smoke.GEN_HW, ann)
        t_cpu = time.perf_counter() - t
        model.use_kernels = True
        m_k = masks_of(res)
        cover_k = smoke.cover_index(m_k)
        print(f"generate scene, boxes {box_px[0]}-{box_px[1]} px: covered share "
              f"{(cover_k >= 0).mean():.4f}; CPU decode {t_cpu:.1f} s", flush=True)
        for label, other in others.items():
            m_o = masks_of(other)
            iou = smoke.mask_iou(m_k, m_o)
            print(f"  K vs {label}: instance IoU mean={iou.mean():.5f} min={iou.min():.5f}, "
                  f"cover agreement={(cover_k == smoke.cover_index(m_o)).mean():.5f}, "
                  f"gray agreement={(res.gray == other.gray).mean():.5f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_drift.py: torch.cuda.is_available() is False; this script runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1_stages()
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    model = smoke.build_model(gen)
    encoder_drift(model)
    generate_drift(model)


if __name__ == "__main__":
    main()
