"""Logging and seeding of the training entry points (mirrors
samrs_tpu/core/logging_utils.py; reference ED/main_pretrain.py:81-107,
448-449).

Python logging to stderr on every rank and to ``log.txt`` on rank 0 only,
one ``step N key=value ...`` line of metrics, and seeding with the rank
folded in (the reference reseeds each rank with 2023 + LOCAL_RANK).
"""

from __future__ import annotations

import logging
import os
import random
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank: the process group's, else torchrun's RANK, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def is_main_process() -> bool:
    return process_index() == 0


def setup_logger(name: str = "samrs_tpu_torch", log_dir: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    """stderr on every rank, plus ``log_dir/log.txt`` on rank 0 only."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s"))
        logger.addHandler(sh)
        if log_dir and is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
            fh.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s"))
            logger.addHandler(fh)
    return logger


def log_metrics(logger: logging.Logger, step: int, metrics: Dict[str, Any]) -> None:
    """One line: ``step N k=v ...`` with numbers to 5 significant digits."""
    parts = " ".join(f"{k}={float(v):.5g}" if hasattr(v, "__float__") else f"{k}={v}"
                     for k, v in metrics.items())
    logger.info("step %d %s", step, parts)


def seed_everything(seed: int) -> int:
    """Seed Python's and numpy's generators with `seed` and torch's with the
    rank folded in; returns that rank's seed (JAX folds the process index
    into its key)."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    folded = (int(seed) * 1_000_003 + process_index()) % 2**63
    torch.manual_seed(folded)
    return folded
