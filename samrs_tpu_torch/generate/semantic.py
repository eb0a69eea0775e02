"""Box-prompted semantic and instance label generation, the SAMRS product
(the port of samrs_tpu/generate/semantic.py; reference
GD/main_sam_hbox_semantic.py and GD/main_sam_rhbox_semantic.py).

Per image: one encoder pass (``set_image``), every box decoded in one
bucket-padded batch (``predict_boxes_lowres``, low-res logits stay on the
device), then per chunk of 32 masks K7 upscales, thresholds and bit-packs on
the device and the coverage map (the last instance covering each pixel)
folds on the device (``painter.update_cover``).  Only packed bits cross to
the host, where each chunk's masks become COCO RLE records in one call of
the C codec (``data.rle.rle_encode_batch``).  The gray PNG holds each
pixel's label (255 where no instance covers it), the colour PNG its palette
colour.  ``generate/fleet.py`` drives the same generator on every card.

    python -m samrs_tpu_torch.generate.semantic --dataset dior \\
        --image-dir IMAGES --ann-dir ANNOTATIONS --save-dir OUT
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from samrs_tpu_torch.core.config import GenerateConfig, SamConfig
from samrs_tpu_torch.data.loaders import LOADERS, Annotation
from samrs_tpu_torch.data.mapping import CLASS_SETS
from samrs_tpu_torch.data.rle import rle_encode_batch
from samrs_tpu_torch.data.writers import (ensure_dirs, instance_record, save_color_png,
                                          save_instances_pkl, save_semantic_png)
from samrs_tpu_torch.generate.painter import gray_from_cover, update_cover
from samrs_tpu_torch.geometry.obb import poly_to_hbb
from samrs_tpu_torch.kernels import amg_post
from samrs_tpu_torch.sam.predictor import SamPredictor, _to_numpy, unpackbits2d

CHUNK = 32  # masks postprocessed to full resolution per device step
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".bmp")


@dataclass
class ImageResult:
    gray: np.ndarray
    color: np.ndarray
    records: List[dict]
    n_instances: int


class SemanticGenerator:
    """Runs the per-image generation loop against a SamPredictor."""

    def __init__(self, predictor: SamPredictor, class_names: Sequence[str], chunk: int = CHUNK):
        self.predictor = predictor
        self.class_names = list(class_names)
        self.chunk = chunk

    def _chunk(self, low: torch.Tensor, cover: torch.Tensor, c0: int,
               valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """low (C, g, g) logits of masks c0.. -> (cover folded with the first
        `valid` of them, packed (C, H, ceil(W/8)) uint8 bits)."""
        pred = self.predictor
        cfg = pred.cfg
        post = amg_post.amg_postprocess if pred.model.use_kernels else \
            amg_post.amg_postprocess_plain
        _, _, _, packed = post(low, pred.input_size, pred.original_size, cfg.image_size,
                               cfg.mask_threshold, 1.0)
        h, w = cover.shape
        shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.uint8)
        bits = (packed[:valid, :, :, None] >> shifts) & 1
        live = bits.reshape(valid, h, -1)[:, :, :w].bool()
        return update_cover(cover, live, c0, valid), packed

    def process_image(self, image: np.ndarray, ann: Annotation,
                      rotated: bool = False) -> ImageResult:
        """image: HWC uint8; rotated=True prompts with the enclosing hbox of
        each rotated polygon and adds rbox/rhbox to the records (FAIR1M)."""
        self.predictor.set_image(image)
        return self.process_with_set_image(image.shape[:2], ann, rotated)

    def process_encoded(self, encoded, hw: Tuple[int, int], ann: Annotation,
                        rotated: bool = False) -> ImageResult:
        """Variant taking (features, original_size, input_size) of one image."""
        self.predictor.set_image_features(*encoded)
        return self.process_with_set_image(hw, ann, rotated)

    @torch.no_grad()
    def process_with_set_image(self, hw: Tuple[int, int], ann: Annotation,
                               rotated: bool = False) -> ImageResult:
        boxes = poly_to_hbb(ann.polys.reshape(-1, 8)) if rotated else ann.hboxes
        labels = np.asarray(ann.labels, np.int32)
        n = boxes.shape[0]
        h, w = hw
        pred = self.predictor
        low_res, _ = pred.predict_boxes_lowres(boxes, multimask_output=False)
        chunk = min(self.chunk, low_res.shape[0])  # buckets and chunk are powers of two
        cover = torch.full((h, w), -1, dtype=torch.int32, device=low_res.device)
        records: List[dict] = []
        for c0 in range(0, n, chunk):
            valid = min(chunk, n - c0)
            cover, packed = self._chunk(low_res[c0:c0 + chunk, 0].contiguous(), cover, c0, valid)
            masks = unpackbits2d(_to_numpy(packed[:valid]), w)
            for j, (m, rle) in enumerate(zip(masks, rle_encode_batch(masks))):
                i = c0 + j
                records.append(instance_record(
                    rle, bbox=boxes[i], label=int(labels[i]),
                    category=self.class_names[int(labels[i])], area=int(m.sum()),
                    rbox=ann.polys[i].reshape(-1) if rotated else None,
                    rhbox=boxes[i] if rotated else None))
        gray, color = gray_from_cover(_to_numpy(cover), labels)
        return ImageResult(gray=gray, color=color, records=records, n_instances=n)


def worklist(cfg: GenerateConfig, image_list: Optional[Sequence[str]] = None) -> List[str]:
    """This shard's image names: `image_list` (default: the sorted stems of
    cfg.image_dir's images), every shard_count-th from shard_index."""
    if image_list is None:
        image_list = sorted(os.path.splitext(f)[0] for f in os.listdir(cfg.image_dir)
                            if f.lower().endswith(IMAGE_EXTS))
    return [name for i, name in enumerate(image_list) if i % cfg.shard_count == cfg.shard_index]


def find_image(image_dir: str, name: str) -> Optional[str]:
    paths = [os.path.join(image_dir, name + ext) for ext in IMAGE_EXTS]
    return next((p for p in paths if os.path.exists(p)), None)


def output_dirs(cfg: GenerateConfig) -> dict:
    """{"gray", "color", "ins"} -> directories under cfg.save_dir (made)."""
    dirs = {k: os.path.join(cfg.save_dir, k) for k in ("gray", "color", "ins")}
    ensure_dirs(*dirs.values())
    return dirs


def save_result(dirs: dict, name: str, result: ImageResult) -> None:
    save_semantic_png(os.path.join(dirs["gray"], name + ".png"), result.gray)
    save_color_png(os.path.join(dirs["color"], name + ".png"), result.color)
    save_instances_pkl(os.path.join(dirs["ins"], name + ".pkl"), result.records)


def generate_semantic(cfg: GenerateConfig, image_list: Optional[Sequence[str]] = None,
                      predictor: Optional[SamPredictor] = None,
                      sam_overrides: Optional[dict] = None) -> int:
    """Iterate the (sharded) image worklist and write gray/color PNGs and
    instance pkls under cfg.save_dir.  Returns the number of images done.
    `predictor` replaces the model built from cfg (on cfg.device)."""
    from PIL import Image

    from samrs_tpu_torch.sam.build import build_sam

    rotated = cfg.dataset in ("fair1m",)
    loader = LOADERS[cfg.dataset]
    if predictor is None:
        model = build_sam(cfg.sam_variant, checkpoint=cfg.sam_checkpoint, device=cfg.device,
                          **(sam_overrides or {}))
        predictor = SamPredictor(model, buckets=cfg.box_buckets)
    gen = SemanticGenerator(predictor, CLASS_SETS[cfg.dataset])

    image_list = worklist(cfg, image_list)
    dirs = output_dirs(cfg)

    done = 0
    for name in image_list:
        ann = loader(name, cfg.ann_dir)
        if ann.error and ann.num_instances == 0:
            print(f"skip {name}: no boxes")
            continue
        img_path = find_image(cfg.image_dir, name)
        if img_path is None:
            print(f"skip {name}: image not found")
            continue
        with Image.open(img_path) as im:
            image = np.asarray(im.convert("RGB"))
        t0 = time.perf_counter()
        result = gen.process_image(image, ann, rotated=rotated)
        save_result(dirs, name, result)
        done += 1
        print(f"[{done}/{len(image_list)}] {name}: {result.n_instances} boxes "
              f"in {time.perf_counter() - t0:.2f}s")
    return done


def _coerce(value: str, default):
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(default, tuple):
        return tuple(type(default[0])(v) for v in value.split(","))
    return type(default)(value)


def parse_args(description: str, argv: Optional[Sequence[str]] = None):
    """The generate CLIs' flags -> (GenerateConfig, SamConfig overrides)."""
    p = argparse.ArgumentParser(description=description)
    # hrsc has a loader but no class set, so the label writer cannot name its classes
    p.add_argument("--dataset", default="dior", choices=["dota", "dior", "fair1m"])
    p.add_argument("--sam-variant", default="vit_h")
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--ann-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--shard-count", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sam-override", action="append", default=[], metavar="KEY=VALUE",
                   help="SamConfig field override (e.g. image_size=256)")
    a = p.parse_args(argv)
    cfg = GenerateConfig(dataset=a.dataset, sam_variant=a.sam_variant,
                         sam_checkpoint=a.sam_checkpoint, image_dir=a.image_dir,
                         ann_dir=a.ann_dir, save_dir=a.save_dir, shard_index=a.shard_index,
                         shard_count=a.shard_count, device=a.device)
    return cfg, parse_sam_overrides(a.sam_override)


def parse_sam_overrides(pairs: Sequence[str]) -> dict:
    """``--sam-override KEY=VALUE`` strings -> SamConfig field overrides,
    each value coerced to its field's type."""
    defaults = {f.name: f.default for f in dataclasses.fields(SamConfig)}
    overrides = {}
    for kv in pairs:
        key, value = kv.split("=", 1)
        if key not in defaults:
            raise SystemExit(f"unknown SamConfig field {key!r}")
        overrides[key] = _coerce(value, defaults[key])
    return overrides


def main(argv: Optional[Sequence[str]] = None) -> None:
    cfg, overrides = parse_args("SAMRS semantic label generation (PyTorch, CUDA)", argv)
    generate_semantic(cfg, sam_overrides=overrides)


if __name__ == "__main__":
    main()
