"""Host-side augmentation for segmentation training (the port's copy of
samrs_tpu/data/transforms.py; reference: the albumentations pipelines of
ED/main_pretrain.py:157-180 and the ImageNet normalisation of
ED/datasets.py:66-88).  numpy only.

cv2 is not installed on the machine with the card, so ``_resize``
reproduces cv2.resize in numpy: ``INTER_LINEAR`` (half-pixel centres, the
source index clamped at the edges; within 1 grey level of cv2, which rounds
its weights to 11 bits) for images and ``INTER_NEAREST`` (the source pixel
floor(dst * src / dst_size), not the half-pixel centre) for label masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _linear_taps(src: int, dst: int):
    """cv2 INTER_LINEAR source indices (lo, hi) and weight of hi per output."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    w = (f - lo).astype(np.float32)
    w[lo < 0] = 0.0
    lo = np.clip(lo, 0, src - 1)
    w[lo >= src - 1] = 0.0
    return lo, np.minimum(lo + 1, src - 1), w


def _resize(img: np.ndarray, hw: Tuple[int, int], is_mask: bool) -> np.ndarray:
    """cv2.resize(img, (w, h)) with INTER_NEAREST for masks, INTER_LINEAR else."""
    (H, W), (h, w) = img.shape[:2], hw
    if is_mask:
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
        return img[ys][:, xs]
    y0, y1, wy = _linear_taps(H, h)
    x0, x1, wx = _linear_taps(W, w)
    f = img.astype(np.float32)
    wx = wx.reshape((1, w) + (1,) * (img.ndim - 2))
    rows0 = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    rows1 = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    wy = wy.reshape((h, 1) + (1,) * (img.ndim - 2))
    out = rows0 * (1 - wy) + rows1 * wy
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


@dataclass
class TrainAugment:
    """Random scale -> pad -> random crop -> flips -> rot90 -> photometric.

    Thread safety: DataLoader calls transforms from a ThreadPoolExecutor and
    numpy Generators are NOT thread-safe, so each worker thread draws from its
    own Generator spawned deterministically from `seed` (SeedSequence([seed, i])
    for the i-th thread to touch this instance).  Passing an explicit `rng`
    bypasses this (single-threaded/test use only).
    """

    size: int = 224
    scale_limit: Tuple[float, float] = (-0.5, 1.0)
    scale_p: float = 0.5
    photo_p: float = 0.3
    ignore_label: int = 255
    seed: int = 0
    rng: Optional[np.random.Generator] = None

    def __post_init__(self) -> None:
        import threading

        self._local = threading.local()
        self._spawn_lock = threading.Lock()
        self._n_spawned = 0

    def _thread_rng(self) -> np.random.Generator:
        if self.rng is not None:
            return self.rng
        r = getattr(self._local, "rng", None)
        if r is None:
            with self._spawn_lock:
                i = self._n_spawned
                self._n_spawned += 1
            r = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
            self._local.rng = r
        return r

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        r = self._thread_rng()
        h, w = image.shape[:2]
        if r.random() < self.scale_p:
            s = 1.0 + r.uniform(*self.scale_limit)
            nh, nw = max(1, int(h * s)), max(1, int(w * s))
            image = _resize(image, (nh, nw), False)
            mask = _resize(mask, (nh, nw), True)
            h, w = nh, nw
        # pad if needed (image 0, mask ignore) — centered like albumentations
        ph, pw = max(0, self.size - h), max(0, self.size - w)
        if ph or pw:
            t, b = ph // 2, ph - ph // 2
            l_, r_ = pw // 2, pw - pw // 2
            image = np.pad(image, ((t, b), (l_, r_), (0, 0)))
            mask = np.pad(mask, ((t, b), (l_, r_)), constant_values=self.ignore_label)
            h, w = image.shape[:2]
        # random crop
        y0 = int(r.integers(0, h - self.size + 1))
        x0 = int(r.integers(0, w - self.size + 1))
        image = image[y0 : y0 + self.size, x0 : x0 + self.size]
        mask = mask[y0 : y0 + self.size, x0 : x0 + self.size]
        # flips + rot90
        if r.random() < 0.5:
            image, mask = image[:, ::-1], mask[:, ::-1]
        if r.random() < 0.5:
            image, mask = image[::-1], mask[::-1]
        k = int(r.integers(0, 4))
        if k:
            image, mask = np.rot90(image, k), np.rot90(mask, k)
        # photometric (image only)
        if r.random() < self.photo_p:
            mode = r.integers(0, 3)
            img_f = image.astype(np.float32)
            if mode == 0:  # contrast
                alpha = 1.0 + r.uniform(-0.2, 0.2)
                img_f = (img_f - img_f.mean()) * alpha + img_f.mean()
            elif mode == 1:  # gamma
                gamma = r.uniform(0.8, 1.2)
                img_f = 255.0 * np.power(np.clip(img_f / 255.0, 0, 1), gamma)
            else:  # brightness
                img_f = img_f * (1.0 + r.uniform(-0.2, 0.2))
            image = np.clip(img_f, 0, 255).astype(image.dtype)
        return np.ascontiguousarray(image), np.ascontiguousarray(mask)


@dataclass
class EvalAugment:
    """Center crop (pad first if smaller), matching val_trfm."""

    size: int = 224
    ignore_label: int = 255

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        h, w = image.shape[:2]
        ph, pw = max(0, self.size - h), max(0, self.size - w)
        if ph or pw:
            t, b = ph // 2, ph - ph // 2
            l_, r_ = pw // 2, pw - pw // 2
            image = np.pad(image, ((t, b), (l_, r_), (0, 0)))
            mask = np.pad(mask, ((t, b), (l_, r_)), constant_values=self.ignore_label)
            h, w = image.shape[:2]
        y0, x0 = (h - self.size) // 2, (w - self.size) // 2
        return (
            np.ascontiguousarray(image[y0 : y0 + self.size, x0 : x0 + self.size]),
            np.ascontiguousarray(mask[y0 : y0 + self.size, x0 : x0 + self.size]),
        )


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8 HWC -> fp32 ImageNet-normalized (ED/datasets.py:85-87)."""
    return (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
