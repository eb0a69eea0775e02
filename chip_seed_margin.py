#!/usr/bin/env python3
"""How far the smoke's generate check sits from its bound across seeded models.

    python3 chip_seed_margin.py [--seeds 0 1 2 3] [--image-size 512]

On one CUDA card, for each seed: a ViT-H built as ``chip_smoke.py`` builds
it (from a generator seeded with the seed) at ``--image-size``, then
``chip_smoke.generate_phase`` (the 800x800 scene with 100 DIOR boxes) with
the kernels against the plain path, and again with K12's plain version in
the kernel path (at image sizes whose global grid is under 2048 tokens the
global layers take K12).  Each run prints the instance IoU, the cover and
gray agreement and the covered share, and whether ``chip_smoke.py``'s bound
(0.99) held.  Information only: it checks nothing and exits 0.  Copied into
another tree's checkout, it runs that tree's port, so two trees can be held
side by side on the same seeded models.
"""

from __future__ import annotations

import argparse
import gc
import subprocess

import torch

import chip_smoke as smoke


def attempt(model, label: str, want) -> None:
    try:
        smoke.generate_phase(model, want=want)
        print(f"{label}: bound held", flush=True)
    except RuntimeError as e:  # the phase prints its agreement before it raises
        print(f"{label}: bound missed ({e})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--image-size", type=int, default=512, choices=(512, 256))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_seed_margin.py: no CUDA device")
    from samrs_tpu_torch.kernels import _build, window_attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    kernel = window_attention.window_attention_relpos
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = smoke.build_model(gen, image_size=args.image_size)
        attempt(model, f"seed {seed}, kernels", smoke.SIZE_GEN_LAUNCHES)
        window_attention.window_attention_relpos = window_attention.window_attention_relpos_plain
        try:
            attempt(model, f"seed {seed}, K12's plain version in the kernel path",
                    dict(smoke.SIZE_GEN_LAUNCHES, K12=0))
        finally:
            window_attention.window_attention_relpos = kernel
        del model
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
