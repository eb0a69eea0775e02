"""SamPredictor: the user-facing inference API (mirrors
samrs_tpu/sam/predictor.py; reference: segment_anything predictor.py).

``set_image`` resizes the longest side to the model's image size,
normalises and zero-pads to the square on the device (``sam.preprocess``, as
the reference does), and caches the encoder features; ``encode_images``
encodes several images in one encoder pass for ``set_image_features``.
``predict_boxes`` decodes every box in one batched
call, padded up to a bucket size with not-a-point prompts; buckets above
``decode_chunk`` prompts decode chunk by chunk to bound the decoder's
per-prompt image-side activations.  ``predict_boxes_lowres`` keeps the
decoded low-res logits on the device for the generate driver, whose binary
masks leave the device bit-packed (``packbits2d``, np.packbits order).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from samrs_tpu_torch.kernels.amg_post import packbits2d
from samrs_tpu_torch.sam.sam import Sam, postprocess_masks, preprocess
from samrs_tpu_torch.sam.transforms import ResizeLongestSide

DEFAULT_BUCKETS = (1, 4, 16, 64, 256, 1024, 4096)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of `t`.  A CUDA tensor goes through page-locked staging from
    torch's caching host allocator: copying a 64-box batch of 768x1024 masks
    and its low-res logits (67 MB) into pageable memory took 27 ms on an
    H100 80GB HBM3 at a 700 W power limit (PERF.md)."""
    if not t.is_cuda:
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


__all__ = ["DEFAULT_BUCKETS", "SamPredictor", "packbits2d", "unpackbits2d"]


def unpackbits2d(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of ``packbits2d``: (..., ceil(W/8)) uint8 -> (..., W) bool."""
    return np.unpackbits(np.asarray(packed, np.uint8), axis=-1)[..., :width].astype(bool)


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


class SamPredictor:
    def __init__(self, model: Sam, buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 decode_chunk: int = 256) -> None:
        self.model = model
        self.cfg = model.cfg
        self.device = model.image_encoder.pos_embed.device
        self.buckets = buckets
        self.decode_chunk = decode_chunk
        self.transform = ResizeLongestSide(self.cfg.image_size)
        self.reset_image()

    def reset_image(self) -> None:
        self.is_image_set = False
        self.features: Optional[torch.Tensor] = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------------ image

    @torch.no_grad()
    def set_image(self, image: np.ndarray, image_format: str = "RGB") -> None:
        """HWC uint8 image -> cached encoder features."""
        if image_format not in ("RGB", "BGR"):
            raise ValueError(f"image_format must be RGB or BGR, got {image_format!r}")
        if image_format == "BGR":
            image = image[..., ::-1]
        cfg = self.cfg
        self.original_size = tuple(image.shape[:2])
        resized = np.ascontiguousarray(self.transform.apply_image(image))
        self.input_size = tuple(resized.shape[:2])
        x = torch.from_numpy(resized).to(self.device)[None]
        x = preprocess(x, cfg.pixel_mean, cfg.pixel_std, cfg.image_size)
        self.features = self.model.encode_image(x)
        self.is_image_set = True

    @torch.no_grad()
    def encode_images(self, images: Sequence[np.ndarray]
                      ) -> List[Tuple[torch.Tensor, Tuple[int, int], Tuple[int, int]]]:
        """HWC uint8 images of any sizes -> [(features (1, g, g, C),
        original_size, input_size)] for ``set_image_features``, from one
        encoder pass over the batch.  Each image is resized, normalised and
        zero-padded as ``set_image`` does it: the encoder sees what
        ``set_image`` gives it, image by image."""
        cfg = self.cfg
        x, metas = [], []
        for image in images:
            resized = np.ascontiguousarray(self.transform.apply_image(image))
            metas.append((tuple(image.shape[:2]), tuple(resized.shape[:2])))
            x.append(preprocess(torch.from_numpy(resized).to(self.device)[None], cfg.pixel_mean,
                                cfg.pixel_std, cfg.image_size))
        x = torch.cat(x)
        feats = self.model.encode_image(x)
        return [(feats[i:i + 1], orig, inp) for i, (orig, inp) in enumerate(metas)]

    def set_image_features(self, features: torch.Tensor, original_size: Tuple[int, int],
                           input_size: Tuple[int, int]) -> None:
        """Install precomputed encoder features (1, g, g, C) for an image of
        `original_size` resized to `input_size`."""
        self.features = features.to(self.device)
        self.original_size = tuple(original_size)
        self.input_size = tuple(input_size)
        self.is_image_set = True

    def get_image_embedding(self) -> torch.Tensor:
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) first.")
        return self.features

    # ---------------------------------------------------------------- predict

    @torch.no_grad()
    def _decode(self, points: np.ndarray, labels: np.ndarray,
                mask_input: Optional[np.ndarray], multimask_output: bool):
        pts = torch.from_numpy(points).to(self.device)
        labs = torch.from_numpy(labels).to(self.device)
        mi = None
        if mask_input is not None:
            mi = torch.from_numpy(np.asarray(mask_input, np.float32)).to(self.device)
        n, chunk = pts.shape[0], self.decode_chunk
        if mi is not None or n <= chunk or n % chunk:
            return self.model.predict(self.features, pts, labs, mi, multimask_output)
        outs = [self.model.predict(self.features, pts[i:i + chunk], labs[i:i + chunk], None,
                                   multimask_output) for i in range(0, n, chunk)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    @torch.no_grad()
    def _finish(self, low_res: torch.Tensor, iou: torch.Tensor, n: int, return_logits: bool):
        masks = postprocess_masks(low_res[:n], self.input_size, self.original_size,
                                  self.cfg.image_size)
        if not return_logits:
            masks = masks > self.cfg.mask_threshold
        return _to_numpy(masks), _to_numpy(iou[:n]), _to_numpy(low_res[:n])

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One prompt set -> (masks (M, H, W), iou (M,), low_res (M, 4g, 4g))."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) first.")
        parts_p, parts_l = [], []
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels are required with point_coords")
            parts_p.append(self.transform.apply_coords(point_coords, self.original_size))
            parts_l.append(np.asarray(point_labels, np.int64))
            if box is None:  # not-a-point pad (prompt_encoder.py:81-87)
                parts_p.append(np.zeros((1, 2), np.float32))
                parts_l.append(np.full((1,), -1, np.int64))
        if box is not None:
            tb = self.transform.apply_boxes(np.asarray(box).reshape(1, 4), self.original_size)
            parts_p.append(tb.reshape(2, 2))
            parts_l.append(np.array([2, 3], np.int64))
        if parts_p:
            pts = np.concatenate(parts_p).astype(np.float32)
            labs = np.concatenate(parts_l)
        elif mask_input is not None:  # mask-only prompt: zero sparse tokens
            pts, labs = np.zeros((0, 2), np.float32), np.zeros((0,), np.int64)
        else:
            raise ValueError("at least one of point_coords/box/mask_input required")
        mi = None if mask_input is None else np.asarray(mask_input).reshape(1, *mask_input.shape[-2:], 1)
        low_res, iou = self._decode(pts[None], labs[None], mi, multimask_output)
        masks, iou, low_res = self._finish(low_res, iou, 1, return_logits)
        return masks[0], iou[0], low_res[0]

    def predict_boxes_lowres(self, boxes: np.ndarray,
                             multimask_output: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 4) xyxy boxes -> (low_res (Nb, M, 4g, 4g), iou (Nb, M)) device
        tensors, Nb the bucket-padded N, decoded in one batch."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) first.")
        n = boxes.shape[0]
        nb = _bucket(n, self.buckets)
        tb = self.transform.apply_boxes(boxes, self.original_size).reshape(-1, 2, 2)
        pts = np.zeros((nb, 2, 2), np.float32)
        labs = np.full((nb, 2), -1, np.int64)
        pts[:n] = tb
        labs[:n, 0] = 2  # top-left corner embedding
        labs[:n, 1] = 3  # bottom-right corner embedding
        return self._decode(pts, labs, None, multimask_output)

    @torch.no_grad()
    def upscale_chunk(self, low_res_chunk: torch.Tensor, binarize: bool = True) -> torch.Tensor:
        """(C, M, 4g, 4g) low-res logits -> (C, M, *original_size) on the
        device: logits, or masks thresholded at ``mask_threshold``."""
        masks = postprocess_masks(low_res_chunk, self.input_size, self.original_size,
                                  self.cfg.image_size)
        return masks > self.cfg.mask_threshold if binarize else masks

    def fetch_masks_packed(self, masks: torch.Tensor) -> np.ndarray:
        """Device binary masks (..., H, W) -> host bool array of that shape,
        bit-packed on the device for the copy (8x fewer bytes)."""
        return unpackbits2d(_to_numpy(packbits2d(masks)), masks.shape[-1])

    def predict_boxes(self, boxes: np.ndarray, multimask_output: bool = False,
                      return_logits: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(N, 4) xyxy boxes -> (masks (N, M, H, W), iou (N, M), low_res (N, M, 4g, 4g)),
        decoded in one bucket-padded batch."""
        low_res, iou = self.predict_boxes_lowres(boxes, multimask_output)
        return self._finish(low_res, iou, boxes.shape[0], return_logits)
