"""Dataset-scale label generation: every local card from one process, with
the host's image decode and label writes overlapped with device work (the
port of samrs_tpu/generate/fleet.py).

  * One worker thread a device, each with its own copy of the model on that
    device.  Images flow through one shared bounded queue; each worker takes
    the next image when it is free, so images with many boxes do not pile
    up on one device.
  * A decode pool loads annotations and images ahead of the workers (at most
    a queue's worth plus one image a decode thread in flight); a writer pool
    writes the PNGs and pkls while the devices work.
  * A worker collects up to ``ENCODE_BATCH`` images, encodes those of one
    shape in one encoder pass (``SamPredictor.encode_images``), then decodes,
    paints and records each image (``SemanticGenerator.process_encoded``).
  * Several hosts split the worklist by ``shard_index`` / ``shard_count``,
    one process each, as the one-image driver does.
  * An error anywhere (decode, worker, writer) stops the feed, and
    ``run_fleet`` re-raises the first one once every thread has ended.

    python -m samrs_tpu_torch.generate.fleet --dataset dior \\
        --image-dir IMAGES --ann-dir ANNOTATIONS --save-dir OUT
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from samrs_tpu_torch.core.config import GenerateConfig
from samrs_tpu_torch.data.loaders import LOADERS
from samrs_tpu_torch.data.mapping import CLASS_SETS
from samrs_tpu_torch.generate.semantic import (SemanticGenerator, find_image, output_dirs,
                                               parse_args, save_result, worklist)
from samrs_tpu_torch.sam.predictor import SamPredictor
from samrs_tpu_torch.sam.sam import Sam

ENCODE_BATCH = 4  # images a worker encodes in one pass (those of one shape)
DECODE_THREADS = 8  # host threads decoding annotations and images ahead of the workers
WRITE_THREADS = 4   # host threads writing the labels
_POLL_S = 0.05    # how often a blocked thread looks for a failure elsewhere


def fleet_devices(device: str) -> List[torch.device]:
    """"cuda": every CUDA card (raises if there is none); anything else:
    that one device ("cpu" only when asked for)."""
    if device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("run_fleet: device 'cuda' needs a CUDA card and none is "
                               "available (pass device='cpu', --device cpu, for the CPU)")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(device)]


def _replica(model: Sam, device: torch.device) -> Sam:
    """`model` on `device`: the model itself if it is there, else a copy."""
    if model.image_encoder.pos_embed.device == device:
        return model
    return copy_to(model, device)


def copy_to(model: Sam, device: torch.device) -> Sam:
    """A copy of `model` on `device` sharing no storage with it: built on the
    meta device, given empty storage there, then its state copied in."""
    with torch.device("meta"):
        copy = Sam(model.cfg, use_kernels=model.use_kernels)
    copy = copy.to_empty(device=device)
    copy.load_state_dict(model.state_dict(), strict=True)
    return copy.eval()


def run_fleet(cfg: GenerateConfig, image_list: Optional[Sequence[str]] = None,
              model: Optional[Sam] = None, stats: Optional[dict] = None, sam_overrides: Optional[dict] = None) -> int:
    """Generate labels for this shard's images on every device of
    ``cfg.device`` and return the number of images written.  `model`
    replaces the one built from cfg; each device gets its own copy.  `stats`,
    if given, receives total, seconds, per_device, busy_time, balance,
    overlap and encode_batches (the images of each encoder pass, in order)."""
    from PIL import Image

    from samrs_tpu_torch.sam.build import build_sam

    devices = fleet_devices(cfg.device)
    rotated = cfg.dataset in ("fair1m",)
    loader = LOADERS[cfg.dataset]
    class_names = CLASS_SETS[cfg.dataset]
    if model is None:
        model = build_sam(cfg.sam_variant, checkpoint=cfg.sam_checkpoint, device=devices[0],
                          **(sam_overrides or {}))
    if devices[0].type == "cuda" and model.use_kernels:
        from samrs_tpu_torch.kernels import _build

        _build.library()  # built here once, not by several workers at once
    models = [_replica(model, d) for d in devices]
    names = worklist(cfg, image_list)
    dirs = output_dirs(cfg)

    n_dev = len(devices)
    work: queue.Queue = queue.Queue(maxsize=max(4 * n_dev, 8))
    decode_pool = ThreadPoolExecutor(max_workers=DECODE_THREADS)
    write_pool = ThreadPoolExecutor(max_workers=WRITE_THREADS)
    writes: List[Future] = []
    errors: List[BaseException] = []
    failed = threading.Event()
    done_count = [0] * n_dev
    busy_time = [0.0] * n_dev
    encode_batches: List[int] = []
    t_start = time.perf_counter()

    def fail(e: BaseException) -> None:
        errors.append(e)
        failed.set()

    def on_written(fut: Future) -> None:
        if fut.exception() is not None:
            fail(fut.exception())

    def decode_one(name: str):
        ann = loader(name, cfg.ann_dir)
        if ann.num_instances == 0:
            return None
        path = find_image(cfg.image_dir, name)
        if path is None:
            return None
        with Image.open(path) as im:
            return name, np.asarray(im.convert("RGB")), ann

    def put(item) -> bool:
        """Queue `item` unless a failure stops the feed first."""
        while not failed.is_set():
            try:
                work.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def feed() -> None:
        try:
            ahead = work.maxsize + DECODE_THREADS
            pending = collections.deque()
            for name in names:
                pending.append(decode_pool.submit(decode_one, name))
                if len(pending) >= ahead:
                    item = pending.popleft().result()
                    if item is not None and not put(item):
                        return
            while pending:
                item = pending.popleft().result()
                if item is not None and not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            fail(e)
        finally:
            put(StopIteration)

    def worker(d: int) -> None:
        try:
            with torch.no_grad(), (torch.cuda.device(devices[d]) if devices[d].type == "cuda"
                                   else contextlib.nullcontext()):
                predictor = SamPredictor(models[d], buckets=cfg.box_buckets)
                gen = SemanticGenerator(predictor, class_names)

                def flush(items) -> None:
                    t0 = time.perf_counter()
                    groups = {}
                    for item in items:
                        groups.setdefault(item[1].shape[:2], []).append(item)
                    for shape, group in groups.items():
                        encoded = predictor.encode_images([im for _, im, _ in group])
                        encode_batches.append(len(group))
                        for (name, _, ann), enc in zip(group, encoded):
                            result = gen.process_encoded(enc, shape, ann, rotated=rotated)
                            fut = write_pool.submit(save_result, dirs, name, result)
                            fut.add_done_callback(on_written)
                            writes.append(fut)
                            done_count[d] += 1
                    if devices[d].type == "cuda":
                        torch.cuda.synchronize(devices[d])
                    busy_time[d] += time.perf_counter() - t0

                items = []
                while not failed.is_set():
                    try:
                        item = work.get(timeout=_POLL_S)
                    except queue.Empty:
                        continue
                    if item is StopIteration:
                        put(StopIteration)  # pass the sentinel on to the next worker
                        if items:
                            flush(items)
                        return
                    items.append(item)
                    if len(items) >= ENCODE_BATCH:
                        flush(items)
                        items = []
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            fail(e)

    threads = [threading.Thread(target=worker, args=(d,), daemon=True) for d in range(n_dev)]
    threads.append(threading.Thread(target=feed, daemon=True))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        failed.set()  # any thread still blocked gives up
        decode_pool.shutdown(wait=True, cancel_futures=True)
        write_pool.shutdown(wait=True)
    for fut in writes:
        if fut.exception() is not None and fut.exception() not in errors:
            errors.append(fut.exception())
    if errors:
        raise errors[0]

    total = sum(done_count)
    dt = time.perf_counter() - t_start
    mean_busy = float(np.mean(busy_time))
    balance = min(busy_time) / max(max(busy_time), 1e-9) if n_dev > 1 else 1.0
    overlap = mean_busy / max(dt, 1e-9)
    print(f"fleet: {total} images on {n_dev} device(s) in {dt:.1f}s "
          f"({total / max(dt, 1e-9):.2f} img/s); per-device imgs {done_count}, "
          f"busy balance min/max {balance:.2f}, host-IO overlap {overlap:.2f}", flush=True)
    if stats is not None:
        stats.update(total=total, seconds=dt, per_device=list(done_count),
                     busy_time=list(busy_time), balance=balance, overlap=overlap,
                     encode_batches=list(encode_batches))
    return total


def main(argv: Optional[Sequence[str]] = None) -> None:
    cfg, overrides = parse_args("SAMRS label generation on every local card (PyTorch, CUDA)",
                                argv)
    run_fleet(cfg, sam_overrides=overrides)


if __name__ == "__main__":
    main()
