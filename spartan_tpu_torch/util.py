"""Logging and timing helpers (port of ``spartan_tpu/util.py``)."""

from __future__ import annotations

import logging
import time
from typing import Any

_log = logging.getLogger("spartan_tpu_torch")
if not _log.handlers:
  _handler = logging.StreamHandler()
  _handler.setFormatter(
      logging.Formatter("%(asctime)s [%(levelname).1s] %(name)s: %(message)s",
                        datefmt="%H:%M:%S"))
  _log.addHandler(_handler)
  _log.propagate = False


def set_log_level(level: int) -> None:
  _log.setLevel(level)


def log_debug(fmt: str, *args: Any) -> None:
  _log.debug(fmt, *args)


def log_info(fmt: str, *args: Any) -> None:
  _log.info(fmt, *args)


class Timer:
  """Accumulating wall-clock timer usable as a context manager."""

  def __init__(self, name: str = ""):
    self.name = name
    self.elapsed = 0.0
    self.count = 0
    self._start = None

  def __enter__(self):
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.elapsed += time.perf_counter() - self._start
    self.count += 1
    return False

  def __repr__(self):
    avg = self.elapsed / max(self.count, 1)
    return f"Timer({self.name}: total={self.elapsed:.4f}s n={self.count} avg={avg:.4f}s)"
