"""Smoke run of spartan_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once through its user entry points, at the
sizes of the reference's benchmark configs 1-3, and raises on any failure:

  0. identify the card (nvidia-smi name and power limit, torch and CUDA);
  1. build kernel K1 (csrc/fused_reduce.cu) from source with nvcc;
  2. K1 against its plain torch version on the card, over five chains,
     four shapes and two accumulators, and both timed at 16384^2 float32;
  3. the fused map+reduce (affine and kernel paths) and a 4096^2 dot,
     against float64 NumPy oracles;
  4. linear-regression training at n = 2^20, d = 64, float64, against a
     NumPy loop, and make_fori against fit.

The last two lines are a JSON object describing each kernel of the path
(its launches during phases 3-4, its worst disagreement with the plain
version, its time and the plain version's time) and the result object
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.examples import linear_reg
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS
from spartan_tpu_torch.util import Timer

DEVICE = "cuda"
KERNEL_SHAPES = [((16384, 16384), torch.float32), ((8192, 8192), torch.bfloat16),
                 ((10_000_019,), torch.float32), ((13, 20), torch.float32)]
TIMED_SHAPE = (16384, 16384)
SUM_N = 16384
DOT_N = 4096
LINREG_N, LINREG_D, LINREG_STEPS, ALPHA = 1 << 20, 64, 5, 0.05
TIMING_REPS = 7


def check(cond: bool, msg: str) -> None:
  if not cond:
    raise RuntimeError(msg)


def rel_err(got: float, want: float) -> float:
  return abs(got - want) / max(abs(want), 1e-300)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def call(name, *deps):
  return FnCallExpr(UFUNCS[name], list(deps))


V, S = LocalInput(0), LocalInput(1)
# name → (chain, uses exp/log, takes a runtime scalar)
CHAINS = {
    "identity": (None, False, False),
    "1+2v": (call("add", LocalConst(1.0), call("multiply", V, LocalConst(2.0))),
             False, False),
    "abs(1+2v)": (call("absolute", call("add", LocalConst(1.0),
                                        call("multiply", V, LocalConst(2.0)))),
                  False, False),
    "exp(-v*v)": (call("exp", call("multiply", call("negative", V), V)),
                  True, False),
    "max(v*s,0.25)": (call("maximum", call("multiply", V, S), LocalConst(0.25)),
                      False, True),
}


def tolerance(transcendental: bool, acc: torch.dtype) -> float:
  if acc == torch.float32:
    return 1e-5   # float32 accumulation in another order
  if transcendental:
    return 1e-6   # exp/log differ by an ulp between CUDA and torch
  return 1e-9     # IEEE-rounded chain, float64 sum: only the order differs


def event_ms(fn) -> float:
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end)


def phase_kernel_vs_plain(device, card: str):
  """K1 against fused_sum_plain on the same card tensors."""
  worst_abs = 0.0
  gen = torch.Generator(device=device).manual_seed(1234)
  launches0 = K.counts["launches"]
  n_cases = 0
  for shape, dtype in KERNEL_SHAPES:
    x = (torch.rand(shape, generator=gen, device=device) * 3 - 1).to(dtype)
    s = torch.tensor(0.7, dtype=torch.float32, device=device)
    for name, (chain, transcendental, has_scalar) in CHAINS.items():
      scalars = [s] if has_scalar else []
      program = K.plan(chain, 0, dtype, dict(enumerate(scalars, start=1)))
      check(program is not None, f"chain {name} did not translate")
      for acc in (torch.float32, torch.float64):
        got = K.fused_sum(x, program, scalars, acc).item()
        want = K.fused_sum_plain(x, program, scalars, acc).item()
        tol = tolerance(transcendental, acc)
        err = rel_err(got, want)
        worst_abs = max(worst_abs, abs(got - want))
        print(f"  K1 {name:14s} {str(tuple(shape)):16s} {str(dtype)[6:]:8s} "
              f"acc={str(acc)[6:]:7s} kernel={got:.17g} plain={want:.17g} "
              f"rel_err={err:.3g} (rtol {tol:g})")
        check(np.isfinite(got) and err <= tol,
              f"K1 disagrees with its plain version: {name} {shape} {dtype} "
              f"{acc}: {got} vs {want}")
        n_cases += 1
    del x
  torch.cuda.synchronize()
  check(K.counts["launches"] == launches0 + n_cases,
        f"launches rose by {K.counts['launches'] - launches0}, expected "
        f"{n_cases}")
  # time at the main path's shape: abs(1+2v) over 16384^2 float32, float64
  # accumulation; kernel and plain in turns
  x = torch.randn(TIMED_SHAPE, generator=gen, device=device)
  program = K.plan(CHAINS["abs(1+2v)"][0], 0, torch.float32, {})
  kernel = lambda: K.fused_sum(x, program, [], torch.float64)
  plain = lambda: K.fused_sum_plain(x, program, [], torch.float64)
  kernel(), plain()
  k_ms, p_ms = [], []
  for _ in range(TIMING_REPS):
    p_ms.append(event_ms(plain))
    k_ms.append(event_ms(kernel))
  ms, plain_ms = statistics.median(k_ms), statistics.median(p_ms)
  gbytes = x.numel() * x.element_size() / 1e9
  print(f"  K1 time at {TIMED_SHAPE} float32, abs(1+2v), float64 acc: "
        f"kernel {ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s), "
        f"plain {plain_ms:.4f} ms (median of {TIMING_REPS}, CUDA events, in "
        f"turns) on {card}")
  return worst_abs, ms, plain_ms


def phase_map_reduce_and_dot(rng):
  b_host = rng.standard_normal((SUM_N, SUM_N), dtype=np.float32)
  b = sp.from_numpy(b_host)
  before = K.counts["launches"]
  with Timer() as t_affine:
    affine = float((sp.ones((SUM_N, SUM_N)) + b * 2).sum().glom())
  check(K.counts["launches"] == before,
        "the affine sum launched K1; it must take the affine rewrite")
  with Timer() as t_fused:
    fused = float(abs(1 + b * 2).sum().glom())
  check(K.counts["launches"] == before + 1,
        "abs(1 + b*2).sum() did not launch K1")
  b64 = b_host.astype(np.float64)
  want_affine = float((1.0 + 2.0 * b64).sum())
  del b64
  # the chain computes in float32 (weak scalars), the sum in float64
  want_fused = float(np.abs(np.float32(1) + b_host * np.float32(2)).sum(
      dtype=np.float64))
  for label, got, want, secs in (("(ones + b*2).sum()", affine, want_affine,
                                  t_affine),
                                 ("abs(1 + b*2).sum()", fused, want_fused,
                                  t_fused)):
    err = rel_err(got, want)
    print(f"  {label} at {SUM_N}^2 float32: {got:.17g} vs NumPy "
          f"{want:.17g}, rel_err {err:.3g} (rtol 1e-9), wall "
          f"{secs.elapsed * 1e3:.1f} "
          "ms incl. first-call setup")
    check(err <= 1e-9, f"{label} disagrees with the NumPy oracle")
  del b, b_host

  a_host = rng.standard_normal((DOT_N, DOT_N), dtype=np.float32)
  c_host = rng.standard_normal((DOT_N, DOT_N), dtype=np.float32)
  with Timer() as t_dot:
    out = sp.dot(sp.from_numpy(a_host), sp.from_numpy(c_host)).glom()
  rows = rng.choice(DOT_N, 64, replace=False)
  want = a_host[rows].astype(np.float64) @ c_host.astype(np.float64)
  check(out.dtype == np.float64 and out.shape == (DOT_N, DOT_N),
        f"dot gave {out.dtype} {out.shape}")
  # rtol 1e-10 elementwise, with an absolute floor of 1e-10 * max|ref| for
  # entries that cancel to near zero (float64 sums in another order)
  err = np.abs(out[rows] - want).max() / np.abs(want).max()
  print(f"  dot {DOT_N}^2 float32 (float64 accumulation): max err "
        f"{err:.3g} of max|ref| on 64 rows (rtol 1e-10), wall "
        f"{t_dot.elapsed * 1e3:.1f} ms incl. transfers")
  np.testing.assert_allclose(out[rows], want, rtol=1e-10,
                             atol=1e-10 * np.abs(want).max())


def phase_training(rng):
  X_host = rng.standard_normal((LINREG_N, LINREG_D))
  y_host = X_host @ rng.standard_normal(LINREG_D) + 0.01 * rng.standard_normal(
      LINREG_N)
  X, y = sp.from_numpy(X_host), sp.from_numpy(y_host)
  torch.cuda.synchronize()
  with Timer() as t_fit:
    w = linear_reg.fit(X, y, LINREG_STEPS, ALPHA).glom()
  w_np = np.zeros(LINREG_D)
  for _ in range(LINREG_STEPS):
    w_np = w_np - ALPHA * (X_host.T @ (X_host @ w_np - y_host)
                           * (2.0 / LINREG_N))
  err = np.abs(w - w_np).max() / np.abs(w_np).max()
  print(f"  linear_reg.fit n={LINREG_N} d={LINREG_D} float64, "
        f"{LINREG_STEPS} steps: max rel err vs NumPy {err:.3g} (rtol 1e-9); "
        f"{t_fit.elapsed / LINREG_STEPS * 1e3:.3f} ms/step incl. first-step setup")
  np.testing.assert_allclose(w, w_np, rtol=1e-9)
  run = sp.make_fori(
      lambda w_: linear_reg.gradient_step(X, y, w_, ALPHA),
      sp.zeros((LINREG_D,)))
  w_fori = run(LINREG_STEPS).glom()
  np.testing.assert_allclose(w_fori, w, rtol=1e-12)
  torch.cuda.synchronize()
  with Timer() as t_fori:
    run(LINREG_STEPS).data.sum().item()
  print(f"  make_fori: equals fit at rtol 1e-12; steady "
        f"{t_fori.elapsed / LINREG_STEPS * 1e3:.3f} ms/step (host clock, synced)")


def main() -> None:
  # phase 0: identify the card; no card, no result
  if not torch.cuda.is_available():
    raise RuntimeError("torch.cuda.is_available() is False: this smoke run "
                       "needs an NVIDIA GPU")
  card = card_line()
  print(card)
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
  sp.initialize([f"--device={DEVICE}"])
  device = sp.get_mesh().device

  print("phase 1: build K1")
  with Timer() as t_build:
    build.load("fused_reduce")
  print(f"  built {build.library_path('fused_reduce').name} in "
        f"{t_build.elapsed:.2f} s")
  for line in build.build_log("fused_reduce").splitlines():
    if "registers" in line or "spill" in line:
      print("  ptxas:", line.strip())

  print("phase 2: K1 against its plain version on the card")
  worst_abs, ms, plain_ms = phase_kernel_vs_plain(device, card)

  rng = np.random.default_rng(0)
  K.reset_counts()  # count the main path's launches only
  print("phase 3: fused map+reduce and dot through the port's entry points")
  phase_map_reduce_and_dot(rng)
  print("phase 4: linear-regression training")
  phase_training(rng)
  launches = K.counts["launches"]
  check(launches >= 1, "the main path never launched K1")

  print(json.dumps({"kernels": [{
      "name": "fused_sum", "route": "cuda",
      "source": "spartan_tpu_torch/csrc/fused_reduce.cu",
      "replaces": "spartan_tpu/backend/kernels/fused_reduce.py:65",
      "launches": launches, "max_abs_err": worst_abs, "ms": ms,
      "plain_ms": plain_ms}]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
