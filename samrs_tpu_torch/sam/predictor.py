"""SamPredictor: the user-facing inference API (mirrors
samrs_tpu/sam/predictor.py; reference: segment_anything predictor.py).

``set_image`` resizes the longest side to the model's image size,
normalises and zero-pads to the square on the device (``sam.preprocess``, as
the reference does), and caches the encoder features; ``encode_images``
encodes several images in one encoder pass for ``set_image_features``.
``predict_boxes``, ``predict_points`` (one single-point prompt set a
point) and ``predict_mask_prompts`` (mask-only prompt sets) decode a whole
batch in one call, padded up to a bucket size with all-pad prompt sets;
buckets above ``decode_chunk`` prompts decode chunk by chunk to bound the
decoder's per-prompt image-side activations.  ``_prompts_to_points`` is the
one merge of point and box prompts that all of them use.
``predict_boxes_lowres`` keeps the decoded low-res logits on the device for
the generate driver, whose binary masks leave the device bit-packed
(``packbits2d``, np.packbits order); ``amg_sweep`` / ``amg_take_packed``
are the automatic mask generator's device sweep and survivor gather.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from samrs_tpu_torch.kernels import amg_post
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
        self._require_image()
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

    def _prompts_to_points(self, point_coords: Optional[np.ndarray],
                           point_labels: Optional[np.ndarray], boxes: Optional[np.ndarray],
                           n: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Merge a batch of prompt sets into the decoder's sparse prompts:
        (B, S, 2) fp32 points in the model's input frame and (B, S) int64
        labels.  point_coords (B, P, 2) with point_labels (B, P) in the
        original image's frame come first; boxes (B, 4) xyxy become two
        corner points labelled 2 and 3; points without a box get one
        not-a-point pad (label -1, prompt_encoder.py:81-87); neither gives
        S = 0, mask-only prompt sets (the reference's empty sparse
        embedding, prompt_encoder.py:155-160), for a batch of `n`."""
        parts_p, parts_l = [], []
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels are required with point_coords")
            pc = np.asarray(point_coords)
            parts_p.append(self.transform.apply_coords(pc, self.original_size))
            parts_l.append(np.asarray(point_labels, np.int64).reshape(pc.shape[:2]))
            if boxes is None:
                parts_p.append(np.zeros((pc.shape[0], 1, 2), np.float32))
                parts_l.append(np.full((pc.shape[0], 1), -1, np.int64))
        if boxes is not None:
            tb = self.transform.apply_boxes(np.asarray(boxes), self.original_size)
            parts_p.append(tb.reshape(-1, 2, 2))
            parts_l.append(np.tile(np.array([[2, 3]], np.int64), (tb.shape[0], 1)))
        if not parts_p:
            return np.zeros((n, 0, 2), np.float32), np.zeros((n, 0), np.int64)
        return (np.concatenate(parts_p, 1).astype(np.float32),
                np.concatenate(parts_l, 1).astype(np.int64))

    @staticmethod
    def _pad_prompts(pts: np.ndarray, labs: np.ndarray, rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pad a batch of prompt sets to `rows` with all-pad sets (points 0,
        labels -1), which the caller slices away after the decode."""
        n = pts.shape[0]
        out_p = np.zeros((rows, *pts.shape[1:]), np.float32)
        out_l = np.full((rows, *labs.shape[1:]), -1, np.int64)
        out_p[:n], out_l[:n] = pts, labs
        return out_p, out_l

    def _require_image(self) -> None:
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) first.")

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One prompt set -> (masks (M, H, W), iou (M,), low_res (M, 4g, 4g))."""
        self._require_image()
        if point_coords is None and box is None and mask_input is None:
            raise ValueError("at least one of point_coords/box/mask_input required")
        pts, labs = self._prompts_to_points(
            None if point_coords is None else np.asarray(point_coords)[None],
            None if point_labels is None else np.asarray(point_labels)[None],
            None if box is None else np.asarray(box).reshape(1, 4), n=1)
        mi = None if mask_input is None else \
            np.asarray(mask_input).reshape(1, *mask_input.shape[-2:], 1)
        low_res, iou = self._decode(pts, labs, mi, multimask_output)
        masks, iou, low_res = self._finish(low_res, iou, 1, return_logits)
        return masks[0], iou[0], low_res[0]

    def predict_points(self, point_coords: np.ndarray, multimask_output: bool = False,
                       return_logits: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(N, 2) foreground points, one single-point prompt set each (the
        point and a not-a-point pad) -> (masks (N, M, H, W), iou (N, M),
        low_res (N, M, 4g, 4g)), decoded in one bucket-padded batch."""
        self._require_image()
        n = point_coords.shape[0]
        pts, labs = self._prompts_to_points(np.asarray(point_coords, np.float32)[:, None],
                                            np.ones((n, 1), np.int64), None)
        low_res, iou = self._decode(*self._pad_prompts(pts, labs, _bucket(n, self.buckets)),
                                    None, multimask_output)
        return self._finish(low_res, iou, n, return_logits)

    def predict_mask_prompts(self, mask_inputs: np.ndarray, multimask_output: bool = False,
                             return_logits: bool = False
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(N, 4g, 4g) low-res logit canvases, one mask-only prompt set each
        (zero sparse tokens: a not-a-point pad would change the decoder's
        token attention) -> (masks (N, M, H, W), iou (N, M), low_res
        (N, M, 4g, 4g)), decoded in one bucket-padded batch."""
        self._require_image()
        n = mask_inputs.shape[0]
        nb = _bucket(n, self.buckets)
        pts, labs = self._pad_prompts(*self._prompts_to_points(None, None, None, n=n), nb)
        mi = np.zeros((nb, *mask_inputs.shape[-2:], 1), np.float32)
        mi[:n] = np.asarray(mask_inputs, np.float32)[..., None]
        low_res, iou = self._decode(pts, labs, mi, multimask_output)
        return self._finish(low_res, iou, n, return_logits)

    def predict_boxes_lowres(self, boxes: np.ndarray,
                             multimask_output: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 4) xyxy boxes -> (low_res (Nb, M, 4g, 4g), iou (Nb, M)) device
        tensors, Nb the bucket-padded N, decoded in one batch."""
        self._require_image()
        n = boxes.shape[0]
        pts, labs = self._prompts_to_points(None, None, boxes)
        return self._decode(*self._pad_prompts(pts, labs, _bucket(n, self.buckets)), None,
                            multimask_output)

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

    @torch.no_grad()
    def amg_sweep(self, pts: np.ndarray, labs: np.ndarray,
                  offset: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """The automatic mask generator's sweep of a crop's point grid:
        pts (G, nb, 2, 2) fp32 and labs (G, nb, 2) prompt sets in the
        model's input frame, uploaded once; each chunk of nb is one
        multimask decode, then K7 (``amg_post.amg_postprocess``; its plain
        version when ``Sam.use_kernels`` is False) on the chunk's nb * 3
        low-res masks at ``offset`` -> (stats (G * nb, 3, 7) fp32, laid
        out [iou, hi, lo, x0, y0, x1, y1] with inclusive boxes; packed
        (G * nb * 3, H, ceil(W / 8)) uint8 bits at the original size), both
        on the device."""
        self._require_image()
        cfg = self.cfg
        post = amg_post.amg_postprocess if self.model.use_kernels else \
            amg_post.amg_postprocess_plain
        pts_d = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(self.device)
        labs_d = torch.from_numpy(np.asarray(labs, np.int64)).to(self.device)
        stats, packed = [], None
        for g in range(pts_d.shape[0]):
            low, iou = self.model.predict(self.features, pts_d[g], labs_d[g], None, True)
            nb, nm = iou.shape
            hi, lo, boxes, bits = post(low.reshape(nb * nm, *low.shape[-2:]), self.input_size,
                                       self.original_size, cfg.image_size, cfg.mask_threshold,
                                       offset)
            stats.append(torch.cat([iou.reshape(-1, 1), hi[:, None].float(), lo[:, None].float(),
                                    boxes.float()], 1).reshape(nb, nm, 7))
            if packed is None:
                packed = torch.empty((pts_d.shape[0] * nb * nm, *bits.shape[1:]),
                                     dtype=torch.uint8, device=bits.device)
            packed[g * nb * nm:(g + 1) * nb * nm] = bits
        return torch.cat(stats), packed

    def amg_take_packed(self, packed: torch.Tensor, idx: np.ndarray) -> np.ndarray:
        """Rows `idx` of ``amg_sweep``'s packed bits, gathered on the device
        and copied to the host at once -> (len(idx), H, ceil(W / 8)) uint8."""
        if len(idx) == 0:
            return np.zeros((0, *packed.shape[1:]), np.uint8)
        return _to_numpy(packed[torch.from_numpy(np.asarray(idx, np.int64)).to(packed.device)])
