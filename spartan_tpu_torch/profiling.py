"""Tracing and profiling hooks (port of ``spartan_tpu/profiling.py``).

``trace`` records a ``torch.profiler`` trace of the host and the card
(CUPTI) into a directory as a Chrome trace; ``annotate`` marks a named
span in it (``torch.profiler.record_function``); the evaluator's counters
(regions built, evaluations, cache hits) come from :func:`region_stats`;
:class:`StepTimer` times the steps of an iterative workload on the host
clock, each step ending in a synchronize of the mesh's device; and
:func:`device_memory_stats` reads ``torch.cuda.memory_stats`` of each
card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from spartan_tpu_torch.util import log_info


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
  """Profile the block (host ops, and the card's kernels where CUDA is
  available) into ``log_dir/trace.json``; yields the profiler, whose
  ``key_averages()`` sums the kernels by name."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  path = os.path.join(log_dir, "trace.json")
  prof.export_chrome_trace(path)
  log_info("profiler trace written to %s", path)


def annotate(name: str):
  """A named span visible in the trace."""
  return torch.profiler.record_function(name)


def region_stats() -> Dict[str, Any]:
  """The evaluator's counters: regions built, evaluations, cache hits."""
  from spartan_tpu_torch.backend import evaluator
  return dict(evaluator.stats)


def reset_region_stats() -> None:
  from spartan_tpu_torch.backend import evaluator
  for k in evaluator.stats:
    evaluator.stats[k] = 0


class StepTimer:
  """Wall-clock and bytes-moved accounting a step of an iterative
  workload: each step ends in a synchronize of the active mesh's device,
  so its time covers the work it queued."""

  def __init__(self):
    self.steps = []

  @contextlib.contextmanager
  def step(self, name: str = "step", bytes_moved: Optional[int] = None):
    from spartan_tpu_torch.core.mesh import get_mesh
    device = get_mesh().device
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rec = {"name": name, "seconds": dt}
    if bytes_moved is not None:
      rec["gbps"] = bytes_moved / dt / 1e9
    self.steps.append(rec)

  def summary(self) -> Dict[str, Any]:
    if not self.steps:
      return {}
    secs = np.array([s["seconds"] for s in self.steps])
    out = {"count": len(self.steps), "total_s": float(secs.sum()),
           "mean_s": float(secs.mean()), "median_s": float(np.median(secs)),
           "p99_s": float(np.percentile(secs, 99))}
    gbps = [s["gbps"] for s in self.steps if "gbps" in s]
    if gbps:
      out["median_gbps"] = float(np.median(gbps))
    return out


def device_memory_stats() -> Dict[str, Any]:
  """``torch.cuda.memory_stats`` of each card, keyed by device name; empty
  without CUDA."""
  if not torch.cuda.is_available():
    return {}
  return {f"cuda:{i}": torch.cuda.memory_stats(i)
          for i in range(torch.cuda.device_count())}
