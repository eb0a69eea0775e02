"""Failure handling of the trainer: graceful shutdown and a stall watchdog
(a copy of samrs_tpu/core/resilience.py, which imports no JAX).

  * GracefulShutdown catches SIGTERM/SIGINT; the train loop polls
    ``should_stop`` and writes a final checkpoint before it exits;
  * Watchdog is a daemon thread that dumps all Python stacks to the log if no
    ``beat()`` arrives within ``timeout_s`` (a hung device or stuck host I/O
    otherwise looks like silence).
"""

from __future__ import annotations

import faulthandler
import logging
import signal
import sys
import threading
import time
from typing import Optional

logger = logging.getLogger("samrs_tpu_torch.resilience")


class GracefulShutdown:
    """Flag-setting signal handler; idempotent install."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread
                pass

    def _handler(self, signum, frame):
        logger.warning("received signal %s: finishing current step then stopping", signum)
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class Watchdog:
    """Stall detector: dumps all thread stacks if beats stop arriving."""

    def __init__(self, timeout_s: float = 600.0, name: str = "train"):
        self.timeout_s = timeout_s
        self.name = name
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()
        self._fired = False

    def stop(self) -> None:
        self._stopped.set()

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        while not self._stopped.wait(min(self.timeout_s / 4, 30.0)):
            if time.monotonic() - self._last > self.timeout_s and not self._fired:
                self._fired = True
                logger.error(
                    "[watchdog:%s] no progress for %.0fs — dumping stacks",
                    self.name, self.timeout_s,
                )
                faulthandler.dump_traceback(file=sys.stderr)
