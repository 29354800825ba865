"""``expr/visualize.py`` and ``profiling.py`` of the port: the DAG's text
and Graphviz renderings against the reference's for the same program
(node kinds, shapes, dtypes and sharing line for line), and the profiling
hooks on the CPU (a ``torch.profiler`` trace written, named spans, the
evaluator's counters, ``StepTimer``'s summary)."""

import json
import os
import re

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.expr import visualize as rvis

import spartan_tpu_torch as sp
from spartan_tpu_torch import profiling
from spartan_tpu_torch.expr import visualize as vis


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _program(pkg, a):
  x = pkg.from_numpy(a)
  return ((x + 1.0) * x).sum(axis=0) + pkg.dot(x, x.T).sum()


def _plain(text: str) -> str:
  """A rendering without the node ids (each package counts its own) and
  with torch's dtype names as NumPy's."""
  return re.sub(r"\[\d+\]|\bn\d+", "", text).replace("torch.", "")


def test_pretty_matches_the_references_rendering():
  a = np.arange(12.0).reshape(3, 4)
  got, want = vis.pretty(_program(sp, a)), rvis.pretty(_program(ref, a))
  assert _plain(got) == _plain(want)
  assert "…shared" in got and got.splitlines()[0].startswith("MapExpr[")


def test_pretty_cuts_at_max_depth():
  x = sp.from_numpy(np.ones(3))
  e = x
  for _ in range(6):
    e = e + 1.0
  lines = vis.pretty(e, max_depth=2).splitlines()
  assert "      …" in lines and len(lines) < 10
  assert len(vis.pretty(e).splitlines()) > len(lines)


def test_dot_export(tmp_path):
  a = np.arange(12.0).reshape(3, 4)
  e = _program(sp, a)
  dot = vis.to_dot(e)
  assert dot.startswith("digraph expr {") and dot.rstrip().endswith("}")
  assert sorted(_plain(dot).splitlines()) == sorted(
      _plain(rvis.to_dot(_program(ref, a))).splitlines())
  path = vis.dump_dot(e, str(tmp_path / "g.dot"))
  with open(path) as f:
    assert f.read() == dot


def test_trace_writes_a_chrome_trace_with_the_named_span(tmp_path):
  x = sp.from_numpy(np.arange(64.0))
  with profiling.trace(str(tmp_path)) as prof:
    with profiling.annotate("the sum"):
      float((x * 2.0).sum().glom())
  assert any(ev.key == "the sum" for ev in prof.key_averages())
  with open(os.path.join(tmp_path, "trace.json")) as f:
    names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
  assert "the sum" in names


def test_region_stats_count_evaluations():
  profiling.reset_region_stats()
  assert set(profiling.region_stats().values()) == {0}
  x = sp.from_numpy(np.arange(8.0))
  (x + 1.0).glom()
  (x + 1.0).glom()
  stats = profiling.region_stats()
  assert stats["evals"] == 2
  assert stats["compiles"] + stats["cache_hits"] + stats["fast_hits"] >= 2


def test_step_timer_summary():
  timer = profiling.StepTimer()
  assert timer.summary() == {}
  for _ in range(5):
    with timer.step("s", bytes_moved=1 << 20):
      sp.from_numpy(np.ones(16)).sum().glom()
  out = timer.summary()
  assert out["count"] == 5 and out["total_s"] > 0
  assert out["median_s"] <= out["p99_s"] and out["median_gbps"] > 0


def test_device_memory_stats_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("checks the CPU-only answer")
  assert profiling.device_memory_stats() == {}
