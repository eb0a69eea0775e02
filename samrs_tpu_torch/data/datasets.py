"""The pretraining dataset and a threaded, prefetching host loader (the
port's copy of samrs_tpu/data/datasets.py; reference ED/datasets.py:14-88).

``SegmentationDataset`` reads the SAMRS gray labels (train.txt / valid.txt
lists, the last ``val_images`` of valid.txt as the val split).
``DataLoader`` yields stacked numpy batches; a thread pool decodes and
augments ``prefetch`` batches ahead of the step.  The epoch order is a
permutation from ``np.random.default_rng(seed + epoch)``, the JAX package's
order, so both packages see the same batches; the trainer moves each batch
to the card through pinned memory.  ``ISPRSDataset`` (Potsdam / Vaihingen,
RGB-coded labels in ``ISPRS_PALETTE``) and ``ISAIDDataset`` are the finetune
datasets (ED/datasets.py:91-267).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
from PIL import Image

from samrs_tpu_torch.data.transforms import normalize_image


class SegmentationDataset:
    """SAMRS pretraining dataset (SOTA/SIOR/FAST gray labels)."""

    def __init__(
        self,
        root: str,
        image_path: str,
        label_path: str,
        ext_img: str = ".png",
        ext_lbl: str = ".png",
        split: str = "trn",
        transform: Optional[Callable] = None,
        val_images: int = 500,
    ):
        with open(os.path.join(root, "train.txt")) as f:
            trn = [ln.strip() for ln in f if ln.strip()]
        with open(os.path.join(root, "valid.txt")) as f:
            val = [ln.strip() for ln in f if ln.strip()]
        if split == "trn":
            names = trn
        elif split == "val":
            names = val[-val_images:]  # last-500 val split (datasets.py:55-56)
        elif split == "tes":
            names = val
        else:
            raise ValueError(split)
        self.files = [os.path.join(image_path, n + ext_img) for n in names]
        self.targets = [os.path.join(label_path, n + ext_lbl) for n in names]
        self.transform = transform

    def __len__(self) -> int:
        return len(self.targets)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        image = np.asarray(Image.open(self.files[i]).convert("RGB"))
        label = np.asarray(Image.open(self.targets[i]))
        if self.transform is not None:
            image, label = self.transform(image, label)
        return normalize_image(image), label.astype(np.int32)


ISPRS_PALETTE = np.array(
    [
        [255, 255, 255],  # impervious surface
        [0, 0, 255],  # building
        [0, 255, 255],  # low vegetation
        [0, 255, 0],  # tree
        [255, 255, 0],  # car
        [255, 0, 0],  # clutter
    ],
    np.uint8,
)


def isprs_rgb_to_label(rgb: np.ndarray, ignore_label: int = 255) -> np.ndarray:
    """RGB-coded ISPRS label -> class indices, `ignore_label` for any other
    colour (ED/datasets.py:120-140)."""
    out = np.full(rgb.shape[:2], ignore_label, np.uint8)
    for i, c in enumerate(ISPRS_PALETTE):
        out[np.all(rgb == c, axis=-1)] = i
    return out


class ISPRSDataset(SegmentationDataset):
    """Potsdam / Vaihingen: RGB label PNGs -> 6 classes (ED/datasets.py:91-175)."""

    NUM_CLASSES = 6

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        image = np.asarray(Image.open(self.files[i]).convert("RGB"))
        label = isprs_rgb_to_label(np.asarray(Image.open(self.targets[i]).convert("RGB")))
        if self.transform is not None:
            image, label = self.transform(image, label)
        return normalize_image(image), label.astype(np.int32)


class ISAIDDataset(SegmentationDataset):
    """iSAID: gray-encoded label PNGs (the first channel of an RGB one),
    16 classes (ED/datasets.py:178-267)."""

    NUM_CLASSES = 16

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        image = np.asarray(Image.open(self.files[i]).convert("RGB"))
        label = np.asarray(Image.open(self.targets[i]))
        if label.ndim == 3:
            label = label[..., 0]
        if self.transform is not None:
            image, label = self.transform(image, label)
        return normalize_image(image), label.astype(np.int32)


class DataLoader:
    """Shuffled, prefetching batch iterator: a thread pool decodes and
    augments `prefetch` batches ahead.  (The JAX loader's per-process
    sharding comes with DDP, ROADMAP.md.)"""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 4, prefetch: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + self.epoch).permutation(n)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._epoch_indices()
        n_batches = len(self)
        self.epoch += 1

        def make_batch(b: int):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in sel]
            xs = np.stack([it[0] for it in items])
            ys = np.stack([it[1] for it in items])
            return xs, ys

        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            pending = deque()
            for b in range(min(self.prefetch, n_batches)):
                pending.append(ex.submit(make_batch, b))
            next_submit = min(self.prefetch, n_batches)
            while pending:
                yield pending.popleft().result()
                if next_submit < n_batches:
                    pending.append(ex.submit(make_batch, next_submit))
                    next_submit += 1


def infinite_loader(loader: DataLoader) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless stream (the reference's while-True over zipped epochs,
    ED/main_pretrain.py:567-579)."""
    while True:
        yield from loader
