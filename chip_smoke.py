"""Smoke run of spartan_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once through its user entry points, at the
sizes of the reference's benchmark configs 1-5 (config 2 also at its
published 32768^2), of PageRank at full width, of ALS at the shape of
MovieLens 20M and of heat and Jacobi-Poisson sweeps on a 16384^2 grid, the
last three also on meshes of 2, 4 and 8 logical shards of the card, and
raises on any failure:

  0. identify the card (nvidia-smi name and power limit, torch and CUDA);
  1. build the kernels (csrc/fused_reduce.cu, spmv_ell.cu, spmv_csr.cu,
     spmm_csr.cu, stencil3x3.cu, stencil3x3_padded.cu, matmul.cu,
     spmv_chunked.cu) from source, one nvcc per file, all started together;
     the sharded kernels are these kernels over the shards' row bands (K3a
     sharded and K3d one launch over a table of bands, K5b and K6b a
     launch a band), K6b the halo-row instantiation in
     stencil3x3_padded.cu;
  2. K1 against its plain torch version on the card, over nine chains
     (power, floor division and remainder among them),
     four shapes, each also as the flattened x[1:] (a base off 16-byte
     alignment), and two accumulators, bit-equal on repeat, with ptxas's
     report of each of its kernels (0-byte stack frame, no spill); then
     each chain timed at 16384^2 float32 beside the plain version and
     torch.sum;
  3. the fused map+reduce (affine and kernel paths) and a 4096^2 dot,
     against float64 NumPy oracles;
  4. linear-regression training at n = 2^20, d = 64, float64, against a
     NumPy loop, and make_fori against fit;
  5. the SpMV kernels K3a (spmv_ell, x in each block's shared memory) and
     K3b (spmv_csr) against their plain versions on six matrices (the two
     PageRank graphs among them), with ptxas's report of each (0-byte stack
     frame, no spill) and the check's power on K3a (without lane 0's
     partial of the longest row, a result must fail it), then timed beside
     their plain versions and cuSPARSE (torch.sparse_csr_tensor @ x), with
     the calls queued ahead of the device so that the events read device
     time, and the host's issue time per call apart;
  6. PageRank through pagerank.fit_sparse(sparse.from_scipy(A)): a GAP
     "urand" graph (uniform random targets, 16 out-edges a node) at
     n = 2^22 (CSR kernel) and n = 32768 (ELL kernel), and the
     block-structured shape of the reference's benchmark config 5 (block
     route, no kernel), each against a float64 scipy power iteration;
  7. a ratings matrix of MovieLens 20M's shape (138,493 users, 26,744
     movies, 20,000,263 ratings, the heaviest user and the most-rated movie
     near the dataset's), drawn on the card from a seed and ingested through
     sparse.from_scipy(R, dtype=np.float32); the SpMM kernel K5a (spmm_csr)
     against its plain version on small odd shapes, k in {1, 3, 64, 130,
     512}, bfloat16/float16/float64 and non-contiguous B, on a skewed
     matrix whose rows split into the kernel's segments (0 to 70,000
     entries, k in {1, 3, 4, 31, 64, 130, 512}), and both ALS products at
     k = 64, with the check's power on the 70,000-entry row (without its
     partials after the first 32, or without one segment, the result must
     fail it), then those two products timed beside the plain version and
     cuSPARSE (torch.sparse_csr_tensor @ B), with their segment counts and
     gathered bytes;
  8. ALS through als.fit(R, k=64, iterations=5) on that matrix, against a
     float64 scipy ALS from the same initial factors, with the RMSE over the
     stored ratings, ms per iteration and a profile of one iteration;
  9. the 3x3 stencil kernels K4 (stencil3x3) and K6a (stencil3x3_padded)
     against their plain versions on six shapes, two coefficient sets,
     float32 (bit for bit), bfloat16 and float16, K6a with and without its
     add field over 1-3 steps, then timed at 16384^2 float32 beside their
     plain versions and cuDNN (F.conv2d, TF32 off);
 10. heat.simulate_padded and poisson.solve_jacobi, 200 sweeps each on a
     16384^2 float32 grid, against float64 iterations on the card; the
     expression path heat.simulate at 4096^2 float64 against
     simulate_numpy; convnet.forward and predict on MNIST's test-set shape
     against a float64 numpy forward;
 11. the matrix-product kernel K2 (matmul) against its plain version on
     seven shapes (the 16-bit kernel's full tile, ragged last tiles, K off
     its 64-deep stages, operands it pads), three dtypes, with the ReLU
     epilogue fused and without, and one epilogue outside the op table,
     with ptxas's report of the 16-bit kernel; then matmul.matmul at
     config 2's published 32768^2 float32 against torch.matmul (TF32 off)
     and at bench.py's 8192^2 bfloat16, each timed beside matmul_plain and
     cuBLAS;
 12. the unique-rows SpMV kernel K3c (spmv_chunked) against its plain
     version on eight edge cases in both its forms (x's windows in shared
     memory, and the CSR as it is) and three x dtypes (bit for bit on
     repeat), with the check's power on the full-size results (without one
     window's partial of the longest row, or one chunk's head, a result
     must fail it); timed on phase 5's urand 2^22 graph (unwindowed) and
     phase 7's ML-20M R.T (windowed; both held, not rebuilt) beside its
     plain version, the other form, K3b and cuSPARSE, each pack's form
     counted; make_spmv_windowed over a classic and a unique pack of each,
     by launch counts;
 13. k-means (config 4: n = 2^19, d = k = 64 float32, both centroid
     updates, make_fori and fit_fused) against a float64 NumPy Lloyd, and
     logistic_reg.fit_fused at n = 2^20, d = 64 float64 against a NumPy
     loop;
 14. on meshes of p = 2, 4 and 8 shards of the card: pagerank.fit_sparse
     on phase 6's two urand graphs (K3d at 2^22, K3a sharded at 32768)
     against phase 6's float64 ranks, als.fit on the ratings of phase 7
     (K5b) against phase 8's float64 factors, 200 heat sweeps at 16384^2
     through stencil3x3_padded_sharded (K6b) bit for bit against phase
     10's K6a field and 20 Jacobi sweeps with the add field against a
     float64 oracle; each sharded entry point bit for bit against its
     unsharded kernel (K5b also on phase 7's skewed matrix) and against
     its plain version at the unsharded kernel's bound; each timed at
     full shape beside the unsharded kernel, its plain version and
     cuSPARSE or cuDNN; K3a sharded and K3d one launch a call, their bands
     counted;
 15. the core expression surface at config 1's 16384^2 float32 through the
     entry points: (b ** 2).sum(), (b // 0.3).sum() and (b % 0.7).sum()
     each one K1 launch (no plain route), var, std with ddof, prod over a
     slice, all and any, sliced sums and means, a 4096-row gather, a
     2^22-element (rows, cols) gather, b[b > 2.5] on the device,
     b.at[rows, cols].add(1.0) with duplicates against np.add.at, nanmean
     with NaN planted, each against a float64 NumPy oracle, and how much
     of b[1:-1, 1:-1].sum() is the contiguous copy K1 reads.

The count of each kernel's launches is set to 0 just before the path that
runs it (phases 3-4 and 15 for K1, phase 6 for K3a/K3b, phase 8 for K5a, phase 10
for K6a, phase 11's full-size matmul calls for K2, phase 12's
make_spmv_windowed calls for K3c, phase 14's path at each p for the
sharded kernels, summed over the three meshes) and read just after.  K4 has no caller
in the package: its count is the launches of phase 9's checks.  The
last two lines are a JSON object describing each kernel (its launches on
its path, its worst disagreement with the plain version, its time, the
plain version's, one library call's, and the card's bound for the same
work) and the result object ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as ss
import torch
import torch.nn.functional as F

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse
from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.backend.kernels import matmul as K2
from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.backend.kernels import stencil as K6
from spartan_tpu_torch.examples import (als, convnet, heat, kmeans,
                                        linear_reg, logistic_reg, pagerank,
                                        poisson)
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS
from spartan_tpu_torch.util import Timer

DEVICE = "cuda"
KERNELS = ("fused_reduce", "spmv_ell", "spmv_csr", "spmm_csr", "stencil3x3",
           "stencil3x3_padded", "matmul", "spmv_chunked")
KERNEL_SHAPES = [((16384, 16384), torch.float32), ((8192, 8192), torch.bfloat16),
                 ((10_000_019,), torch.float32), ((13, 20), torch.float32)]
TIMED_SHAPE = (16384, 16384)
SUM_N = 16384
DOT_N = 4096
LINREG_N, LINREG_D, LINREG_STEPS, ALPHA = 1 << 20, 64, 5, 0.05
# PageRank: GAP urand graphs, scale 22 (cut from the suite's 27) and the
# n = 32768 shape at the ELL kernel's limit; config 5's block shape
PR_BIG_N, PR_SMALL_N, PR_DEGREE, PR_ITERS, DAMPING = 1 << 22, 32768, 16, 30, 0.85
CFG5_BLOCKS, CFG5_PER_ROW, CFG5_BS = 64, 8, 128
# ALS at the shape of GroupLens MovieLens 20M (Harper and Konstan, ACM TiiS
# 5(4), 2015): users, rated movies, ratings, the fewest ratings a user has,
# the most a user has and the most a movie has
ML_USERS, ML_MOVIES, ML_RATINGS = 138_493, 26_744, 20_000_263
ML_MIN_USER, ML_MAX_USER, ML_TOP_MOVIE = 20, 9_254, 67_310
# weights of the ratings 0.5, 1.0, ..., 5.0, shaped like the dataset's
# histogram (most at 4.0, then 3.0)
ML_RATING_WEIGHTS = (1.2, 3.4, 1.4, 7.2, 4.4, 21.4, 11.0, 27.8, 7.7, 14.5)
ALS_K, ALS_ITERS, ALS_REG = 64, 5, 0.1
SPMM_KS = (1, 3, 64, 130, 512)
# K5a's long-row checks: k, and the rows of a skewed 2000 x 90,000 matrix
# (short rows of 0-40 entries besides): 0, 1, SEG-1, SEG, SEG+1, 2·SEG and
# 7·SEG+3 entries and one of 70,000, each in its own row band at p = 8
SKEW_KS = (1, 3, 4, 31, 64, 130, 512)
SKEW_N, SKEW_M = 2000, 90_000
SKEW_ROWS = {5: 0, 140: 1, 300: K5.SEG - 1, 520: K5.SEG, 700: K5.SEG + 1,
             1030: 2 * K5.SEG, 1290: 7 * K5.SEG + 3, 1500: 70_000}
# 3x3 stencils: check shapes, coefficient sets, and the full grid (config
# 1's 16384^2) swept by heat (alpha 0.1) and weighted Jacobi
STENCIL_SHAPES = ((1, 1), (3, 5), (13, 20), (64, 256), (1000, 1001),
                  (4097, 130))
LAPLACIAN = (0.0, 1.0, 0.0, 1.0, -4.0, 1.0, 0.0, 1.0, 0.0)
NINE = (0.05, 0.1, 0.02, 0.1, 0.4, -0.1, 0.3, 0.1, 0.03)
HEAT_ALPHA = 0.1
HEAT = (0.0, HEAT_ALPHA, 0.0, HEAT_ALPHA, 1.0 - 4.0 * HEAT_ALPHA, HEAT_ALPHA,
        0.0, HEAT_ALPHA, 0.0)
JACOBI = (0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 0.0)
GRID_N, SWEEPS, CHUNK = 16384, 200, 8
EXPR_N, EXPR_STEPS = 4096, 50
# MNIST's test set: 10,000 images of 1 x 28 x 28; the numpy oracle takes
# the first CONV_CHECK
MNIST_SHAPE, CONV_CHECK = (10_000, 1, 28, 28), 256
# K2: (M, K, N) check shapes; config 2's published 32768^2 float32
# (BASELINE.json configs[1]); bench.py's own config-2 run, 8192^2 bfloat16
# the last three: a full 128 x 256 tile of the 16-bit kernel, ragged last
# tiles in M and N with K = 4·64 - 1, and K = 3·64 - 1 with N % 8 != 0
MATMUL_SHAPES = ((1, 1, 1), (17, 33, 65), (1000, 1001, 999), (64, 256, 128),
                 (128, 64, 256), (257, 255, 250), (300, 191, 520))
CFG2_N, BENCH_MM_N, CFG2_REPS = 32768, 8192, 3
# k-means at bench.py's config-4 shape; logistic regression at config 3's
KM_N, KM_D, KM_K, KM_ITERS = 1 << 19, 64, 64, 10
LOGREG_STEPS, LOGREG_ALPHA = 50, 1.0
TIMING_REPS = 7
SPIN_CYCLES = 20_000_000  # about 10 ms of an H100 SM clock
# H100 SXM: HBM rate, the float32 rate outside the tensor cores and the
# dense bfloat16/float16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


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


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
  """(least ms for this work on an H100 SXM, which of the two bounds it);
  ``peak`` is the rate of the operations' type."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
  return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                     else "operations")


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
    # power with a general exponent (powf/pow: the CUDA math library's ulp
    # bounds, so "transcendental"), with 2 (the square instruction), floor
    # division and remainder (torch's algorithm, IEEE-rounded steps)
    "abs(v)**2.5": (call("power", call("absolute", V), LocalConst(2.5)),
                    True, False),
    "power(v,2)": (call("power", V, LocalConst(2.0)), False, False),
    "v//0.3": (call("floor_divide", V, LocalConst(0.3)), False, False),
    "v%0.7": (call("remainder", V, LocalConst(0.7)), False, False),
}
# K1's abs(1+2v) at 16384^2 float32 before this op table grew (PERF.md,
# PR 8): the new opcodes must not cost it more than 3 %
K1_ABS_MS_PR8 = 0.4680


def tolerance(transcendental: bool, acc: torch.dtype) -> float:
  if acc == torch.float32:
    return 1e-5   # float32 accumulation in another order
  if transcendental:
    return 1e-6   # exp/log differ by an ulp between CUDA and torch
  return 1e-9     # IEEE-rounded chain, float64 sum: only the order differs


def event_ms(fn, inner: int = 1):
  """(device ms, host ms to issue, queued ahead) per call of ``fn`` over
  ``inner`` back-to-back calls.  The calls are queued behind a spin kernel
  (``torch.cuda._sleep``) that outlasts their issue, so the CUDA events time
  the device running them back to back, not the host issuing them; the
  spin is lengthened until it outlasts the issue (``queued ahead``)."""
  cycles = SPIN_CYCLES
  for _ in range(4):
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(cycles)
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(inner):
      fn()
    host = (time.perf_counter() - t0) * 1e3
    marks[2].record()
    marks[2].synchronize()
    ahead = host < 0.5 * marks[0].elapsed_time(marks[1])
    if ahead:
      break
    cycles *= 4
  return marks[1].elapsed_time(marks[2]) / inner, host / inner, ahead


def time_in_turns(fns, inner: int = 1, reps: int = TIMING_REPS):
  """Median device ms of each of ``fns`` (name → callable) over ``reps``
  samples, timed in turns; under ``name + ' host'`` the median host ms to
  issue one call, and under ``name + ' ahead'`` whether every sample was
  queued ahead."""
  for fn in fns.values():
    fn()
  samples = {name: [] for name in fns}
  hosts = {name: [] for name in fns}
  aheads = {name: True for name in fns}
  for _ in range(reps):
    for name, fn in fns.items():
      dev, host, ahead = event_ms(fn, inner)
      samples[name].append(dev)
      hosts[name].append(host)
      aheads[name] = aheads[name] and ahead
  out = {name: statistics.median(v) for name, v in samples.items()}
  out.update({f"{name} host": statistics.median(v)
              for name, v in hosts.items()})
  out.update({f"{name} ahead": v for name, v in aheads.items()})
  return out


def ptxas_report(source: str, entry: str):
  """ptxas's report of each kernel of ``source`` whose mangled name holds
  ``entry``: (mangled name, registers, stack frame bytes, spill store
  bytes, spill load bytes), from the build log."""
  rows, name, frame = [], None, None
  for line in build.build_log(source).splitlines():
    if "Function properties for" in line:
      name = line.split("Function properties for", 1)[1].strip()
    elif name and "stack frame" in line:
      frame = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
    elif name and "Used" in line and "registers" in line and frame:
      regs = int(line.split("Used", 1)[1].split()[0])
      if entry in name:
        rows.append((name, regs, *frame[:3]))
      name, frame = None, None
  return rows


def check_ptxas(source: str, entry: str, label: str) -> None:
  """Prints ptxas's line for each kernel ``entry`` of ``source`` and holds
  each to a 0-byte stack frame and no spill."""
  rows = ptxas_report(source, entry)
  check(rows, f"no ptxas report of {entry} in {source}'s build log")
  for name, regs, frame, stores, loads in rows:
    print(f"  ptxas {label} {name[-48:]}: {regs} registers, {frame} bytes "
          f"stack frame, {stores} bytes spill stores, {loads} bytes spill "
          f"loads")
    check(frame == 0 and stores == 0 and loads == 0,
          f"{label} {name} has a stack frame or spills")


def phase_kernel_vs_plain(device, card: str):
  """K1 against fused_sum_plain on the same card tensors."""
  check_ptxas("fused_reduce", "fused_sum_partials", "K1")
  worst_abs = 0.0
  gen = torch.Generator(device=device).manual_seed(1234)
  launches0 = K.counts["launches"]
  n_cases = 0
  for shape, dtype in KERNEL_SHAPES:
    whole = (torch.rand(shape, generator=gen, device=device) * 3 - 1).to(dtype)
    s = torch.tensor(0.7, dtype=torch.float32, device=device)
    # the tensor, and its flattened x[1:]: a base off 16-byte alignment
    for view, x in (("", whole), (" [1:]", whole.reshape(-1)[1:])):
      for name, (chain, transcendental, has_scalar) in CHAINS.items():
        scalars = [s] if has_scalar else []
        program = K.plan(chain, 0, dtype, dict(enumerate(scalars, start=1)))
        check(program is not None, f"chain {name} did not translate")
        for acc in (torch.float32, torch.float64):
          got = K.fused_sum(x, program, scalars, acc).item()
          again = K.fused_sum(x, program, scalars, acc).item()
          want = K.fused_sum_plain(x, program, scalars, acc).item()
          tol = tolerance(transcendental, acc)
          err = rel_err(got, want)
          worst_abs = max(worst_abs, abs(got - want))
          print(f"  K1 {name:14s} {str(tuple(shape)) + view:21s} "
                f"{str(dtype)[6:]:8s} acc={str(acc)[6:]:7s} kernel={got:.17g} "
                f"plain={want:.17g} rel_err={err:.3g} (rtol {tol:g}); "
                f"repeat bitwise equal: {got == again}")
          check(np.isfinite(got) and err <= tol,
                f"K1 disagrees with its plain version: {name} {shape}{view} "
                f"{dtype} {acc}: {got} vs {want}")
          check(got == again, f"K1 is not deterministic: {name} {shape}{view}")
          n_cases += 2
    del x, whole
  torch.cuda.synchronize()
  check(K.counts["launches"] == launches0 + n_cases,
        f"launches rose by {K.counts['launches'] - launches0}, expected "
        f"{n_cases}")
  # time at the main path's shape: abs(1+2v) over 16384^2 float32, float64
  # accumulation; kernel and plain in turns, with every chain of CHAINS (the
  # identity program among them) and torch.sum(dtype=float64), the library
  # call for that program
  x = torch.randn(TIMED_SHAPE, generator=gen, device=device)
  s = torch.tensor(0.7, dtype=torch.float32, device=device)
  program = K.plan(CHAINS["abs(1+2v)"][0], 0, torch.float32, {})
  fns = {"plain": lambda: K.fused_sum_plain(x, program, [], torch.float64)}
  programs = {}
  for name, (chain, _, has_scalar) in CHAINS.items():
    scalars = [s] if has_scalar else []
    programs[name] = K.plan(chain, 0, torch.float32,
                            dict(enumerate(scalars, start=1)))
    fns[name] = (lambda p=programs[name], sc=scalars:
                 K.fused_sum(x, p, sc, torch.float64))
  fns["torch.sum"] = lambda: torch.sum(x, dtype=torch.float64)
  t = time_in_turns(fns)
  t["kernel"] = t["abs(1+2v)"]
  nbytes = x.numel() * x.element_size()
  bound_ms, bound_by = bound(nbytes + 8, x.numel() * len(program.instrs))
  print(f"  K1 time at {TIMED_SHAPE} float32, abs(1+2v), float64 acc: "
        f"kernel {t['kernel']:.4f} ms ({nbytes / t['kernel'] / 1e6:.1f} GB/s; "
        f"{100 * (t['kernel'] / K1_ABS_MS_PR8 - 1):+.2f} % against PR 8's "
        f"{K1_ABS_MS_PR8} ms), "
        f"plain {t['plain']:.4f} ms, torch.sum(dtype=float64) "
        f"{t['torch.sum']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}) "
        f"(median of {TIMING_REPS}, queued ahead of the device, CUDA events, "
        f"in turns) on {card}")
  for name, p in programs.items():
    print(f"  K1 chain {name:14s} {t[name]:.4f} ms: {len(p.instrs)} "
          f"instructions, {1 + max(d for _, _, d, _, _ in p.instrs)} "
          f"register(s), {'float' if p.float_regs else 'double'} registers "
          f"on {card}")
  return {"max_abs_err": worst_abs, "ms": t["kernel"], "plain_ms": t["plain"],
          "library_ms": t["torch.sum"], "bound_ms": bound_ms,
          "bound_by": bound_by}


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


# -- sparse ---------------------------------------------------------------------

def urand_graph(n: int, seed: int):
  """GAP's urand graph as a column-stochastic float32 link matrix: node j
  has PR_DEGREE out-edges to uniformly random targets i, A[i, j] = 1/16
  per edge (a repeated edge adds up), no dangling column."""
  rng = np.random.default_rng(seed)
  dst = rng.integers(0, n, n * PR_DEGREE, dtype=np.int32)
  data = np.full(n * PR_DEGREE, 1.0 / PR_DEGREE, dtype=np.float32)
  indptr = np.arange(0, n * PR_DEGREE + 1, PR_DEGREE, dtype=np.int64)
  return ss.csc_matrix((data, dst, indptr), shape=(n, n))


def config5_graph():
  """The block-structured link matrix of the reference's config 5
  (bench.py's bench_pagerank_step): 64 block-rows of 128, 8 random blocks a
  row, column-normalised, float32."""
  rng = np.random.default_rng(0)
  n = CFG5_BLOCKS * CFG5_BS
  cols_b = rng.integers(0, CFG5_BLOCKS, CFG5_BLOCKS * CFG5_PER_ROW)
  data = rng.random((CFG5_BLOCKS * CFG5_PER_ROW, CFG5_BS, CFG5_BS)).astype(
      np.float32)
  A = ss.bsr_matrix((data, cols_b, np.arange(CFG5_BLOCKS + 1) * CFG5_PER_ROW),
                    shape=(n, n)).tocsr()
  A = A @ ss.diags(1.0 / np.maximum(np.asarray(A.sum(axis=0)).ravel(), 1e-9))
  return A.tocsr().astype(np.float32)


def small_cases():
  """Odd shapes: random, a band of empty rows, one row of 10,000 entries,
  13 x 20."""
  rng = np.random.default_rng(7)
  cases = [("random 1500x2300 d=0.005",
            ss.random(1500, 2300, density=0.005, random_state=3,
                      format="csr", dtype=np.float32))]
  empty = ss.random(4096, 2500, density=0.004, random_state=4, format="lil",
                    dtype=np.float32)
  empty[2048:3072, :] = 0
  cases.append(("rows 2048-3071 empty", empty.tocsr()))
  long_row = ss.random(64, 20000, density=0.0003, random_state=5,
                       format="lil", dtype=np.float32)
  long_row[7, rng.choice(20000, 10_000, replace=False)] = rng.random(
      10_000).astype(np.float32)
  cases.append(("one row of 10000", long_row.tocsr()))
  cases.append(("13x20", ss.random(13, 20, density=0.3, random_state=6,
                                   format="csr", dtype=np.float32)))
  return cases


def spmv_cases(big, small):
  return [("urand 2^22", big), ("urand 32768", small)] + small_cases()


def drop_ell_lane(S, x, got, want, tol, label: str) -> None:
  """The check's power on K3a: ``got`` less lane 0's partial of the
  longest row (the products K3a's form gives lane 0 before the shuffle
  tree) must fail the check that ``got`` passed."""
  cols, vals = S.cols.contiguous(), S.vals.float().contiguous()
  on_chip, vec, group = KS.ell_form(cols, vals, x.shape[0])
  r = int((vals != 0).sum(1).argmax())
  k = cols.shape[1]
  width = 4 if on_chip else 1  # entries a lane's piece
  lane0 = [e for j in range(0, -(-k // width), group)
           for e in range(j * width, min((j + 1) * width, k))]
  part = float((vals[r, lane0].double()
                * x[cols[r, lane0].long()].double()).sum())
  bound = float(tol[r]) if torch.is_tensor(tol) else float(tol)
  err = abs(float(got[r]) - part - float(want[r]))
  print(f"  K3a on {label}: a result without lane 0's partial of row {r} "
        f"({len(lane0)} products, {width} a piece, {vec} a load, {group} "
        f"lanes) is off by "
        f"{err:.4g} against the bound {bound:.4g}")
  check(err > bound, f"K3a's check on {label} passes a result without "
        f"lane 0's partial")


def phase_spmv_kernels(device, card: str, big, small):
  """K3a/K3b against their plain versions on the card, then timed beside
  the plain versions and cuSPARSE."""
  check_ptxas("spmv_ell", "spmv_ell_onchip", "K3a on chip")
  check_ptxas("spmv_ell", "spmv_ell_l2", "K3a through L1")
  check_ptxas("spmv_csr", "spmv_csr_kernel", "K3b/K3d")
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  print(f"  K3a's form: x copied whole into each block's shared memory for "
        f"m <= {KS.ELL_MAX_X} (one block an SM, {sms} SMs, no cluster), a "
        f"row's pieces of 4 entries a lane, loaded 16 bytes at a time where "
        f"k % 4 == 0 and the rows are aligned, else 4 bytes at a time (the "
        f"same sum); else gathered through L1; K3b and K3d read the CSR as "
        f"it is, x gathered from L2 (the form over x's windows in a "
        f"cluster's shared memory lost: PERF.md)")
  gen = torch.Generator(device=device).manual_seed(99)
  worst = {"spmv_ell": 0.0, "spmv_csr": 0.0}
  for label, A in spmv_cases(big, small):
    S = sparse.from_scipy(A)
    indptr, indices, data = S.to_csr()
    x = torch.randn(A.shape[1], generator=gen, device=device)
    long_row = label.startswith("one row")
    if long_row:
      # f32 sums of k terms in two orders: |diff| <= k 2^-24 sum|a x|
      sum_abs = KS.spmv_csr_plain(indptr, indices, data.abs(), x.abs())
      tol = S.max_nnz_per_row * 2.0 ** -24 * sum_abs
    for name, kernel, plain, args in (
        ("spmv_ell", KS.spmv_ell, KS.spmv_ell_plain, (S.cols, S.vals, x)),
        ("spmv_csr", KS.spmv_csr, KS.spmv_csr_plain,
         (indptr, indices, data, x))):
      got, want = kernel(*args), plain(*args)
      again = kernel(*args)
      torch.cuda.synchronize()
      diff = (got - want).abs()
      err = float(diff.max())
      worst[name] = max(worst[name], err)
      scale = float(want.abs().max())
      if long_row:
        ok = bool((diff <= tol).all())
        rule = "per-row k 2^-24 sum|a x|"
      else:
        ok = err <= 1e-5 * scale
        rule = "1e-5 max|y|"
      form = (" (on_chip, vec, group) = "
              f"{KS.ell_form(S.cols, S.vals, A.shape[1])}"
              if name == "spmv_ell" else "")
      print(f"  {name} {label:26s} {A.shape[0]}x{A.shape[1]} nnz={S.nnz} "
            f"k={S.max_nnz_per_row}{form}: max|kernel-plain| {err:.3g} "
            f"(max|y| {scale:.4g}, tolerance {rule}); "
            f"repeat bitwise equal: {bool(torch.equal(got, again))}")
      check(bool(torch.isfinite(got).all()) and ok,
            f"{name} disagrees with its plain version on {label}")
      check(torch.equal(got, again), f"{name} is not deterministic on {label}")
      if name == "spmv_ell" and label in ("urand 32768", "one row of 10000"):
        drop_ell_lane(S, x, got, want, tol if long_row else 1e-5 * scale,
                      label)
    del S, indptr, indices, data, x

  timings = {}
  for label, A, names, inner in (("urand 2^22", big, ("spmv_csr", "spmv_ell"), 20),
                                 ("urand 32768", small, ("spmv_ell",), 200)):
    S = sparse.from_scipy(A)
    indptr, indices, data = S.to_csr()
    n, m = S.shape
    k = S.max_nnz_per_row
    x = torch.randn(m, generator=gen, device=device)
    lib = torch.sparse_csr_tensor(indptr.int(), indices, data, size=(n, m),
                                  check_invariants=False)
    for name in names:
      if name == "spmv_csr":
        args = (indptr, indices, data, x)
        nbytes = S.nnz * 8 + (n + 1) * 8 + (m + n) * 4
        flops = 2 * S.nnz
      else:
        args = (S.cols, S.vals, x)
        nbytes = n * k * 8 + (m + n) * 4
        flops = 2 * n * k
      kernel = getattr(KS, name)
      plain = getattr(KS, f"{name}_plain")
      t = time_in_turns({"plain": lambda: plain(*args),
                         "kernel": lambda: kernel(*args),
                         "cuSPARSE": lambda: lib @ x}, inner)
      bound_ms, bound_by = bound(nbytes, flops)
      print(f"  {name} time on {label} (n={n}, nnz={S.nnz}, k={k}): kernel "
            f"{t['kernel']:.4f} ms ({S.nnz / t['kernel'] / 1e6:.2f} Gnnz/s, "
            f"{nbytes / t['kernel'] / 1e6:.1f} GB/s), plain "
            f"{t['plain']:.4f} ms, cuSPARSE {t['cuSPARSE']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB) "
            f"(median of {TIMING_REPS} x {inner} calls queued ahead of the "
            f"device, CUDA events, in turns; queued ahead: "
            f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuSPARSE'))})"
            f"; host issue per call: kernel {t['kernel host']:.4f} ms, plain "
            f"{t['plain host']:.4f} ms, cuSPARSE {t['cuSPARSE host']:.4f} ms; "
            f"on {card}")
      timings[(name, label)] = {"ms": t["kernel"], "plain_ms": t["plain"],
                                "library_ms": t["cuSPARSE"],
                                "bound_ms": bound_ms, "bound_by": bound_by}
    del S, indptr, indices, data, x, lib
  # each kernel's numbers at the shape its main path gives it
  return {"spmv_csr": dict(timings[("spmv_csr", "urand 2^22")],
                           max_abs_err=worst["spmv_csr"]),
          "spmv_ell": dict(timings[("spmv_ell", "urand 32768")],
                           max_abs_err=worst["spmv_ell"])}


def scipy_pagerank(A) -> np.ndarray:
  A64 = ss.csr_matrix(A, dtype=np.float64)
  n = A64.shape[0]
  r = np.full(n, 1.0 / n)
  for _ in range(PR_ITERS):
    r = DAMPING * (A64 @ r) + (1.0 - DAMPING) / n
  return r


def pagerank_case(label: str, A, want_fmt: str, kernel_count,
                  stochastic: bool = True):
  """fit_sparse(from_scipy(A)) against scipy in float64; returns the
  SparseArray and the float64 ranks (phase 14 runs them again on sharded
  meshes).  ``kernel_count`` is the counts key that must
  rise by at least PR_ITERS, or None for the block route (no kernel).  A
  ``stochastic`` matrix (no dangling column) keeps the ranks' sum at 1."""
  n = A.shape[0]
  with Timer() as t_ingest:
    S = sparse.from_scipy(A)
  fmt = sparse.spmv_expr(S, sp.ones((n,), dtype=S.dtype)).fmt
  check(fmt == want_fmt, f"{label}: SpMVExpr took fmt {fmt!r}, not "
        f"{want_fmt!r}")
  before = dict(KS.counts)
  torch.cuda.synchronize()
  with Timer() as t_fit:
    r = pagerank.fit_sparse(S, iterations=PR_ITERS, damping=DAMPING)
  rose = {k: KS.counts[k] - before[k] for k in KS.counts}
  if kernel_count is None:
    check(not any(rose.values()), f"{label}: the block route launched an "
          f"SpMV kernel ({rose})")
  else:
    check(rose[kernel_count] >= PR_ITERS,
          f"{label}: {kernel_count} rose by {rose[kernel_count]}, expected "
          f">= {PR_ITERS}")
    check(rose["ell_plain_runs"] == rose["csr_plain_runs"] == 0,
          f"{label}: a card tensor reached a plain SpMV ({rose})")
  with Timer() as t_oracle:
    want = scipy_pagerank(A)
  err = float(np.abs(r.astype(np.float64) - want).max())
  total = float(r.sum(dtype=np.float64))
  print(f"  PageRank {label} (n={n}, nnz={S.nnz}, fmt {fmt!r}): "
        f"{PR_ITERS} iterations, max|r - r64| {err:.3g} (<= 1e-5 max r64 = "
        f"{1e-5 * want.max():.3g}), |sum r - 1| {abs(total - 1):.3g} "
        f"({'<= 1e-4' if stochastic else 'dangling columns'}); launches {rose}; from_scipy {t_ingest.elapsed:.2f} s, "
        f"fit_sparse {t_fit.elapsed:.3f} s, scipy oracle "
        f"{t_oracle.elapsed:.2f} s")
  check(r.shape == (n,) and r.dtype == np.float32
        and bool(np.isfinite(r).all()), f"{label}: bad ranks")
  check(err <= 1e-5 * want.max(), f"{label}: disagrees with scipy")
  check(not stochastic or abs(total - 1) <= 1e-4,
        f"{label}: ranks do not sum to 1")
  run = sp.make_fori(
      lambda r_: sparse.spmv_expr(S, r_) * DAMPING + (1.0 - DAMPING) / n,
      sp.ones((n,), dtype=S.dtype) / n)
  run(2).data.sum().item()
  torch.cuda.synchronize()
  with Timer() as t_steady:
    run(PR_ITERS).data.sum().item()
  ms = t_steady.elapsed / PR_ITERS * 1e3
  print(f"  make_fori steady {ms:.4f} ms/step, {S.nnz / ms / 1e6:.3f} "
        "Gnnz/s (host clock, synced)")
  return S, want


def phase_pagerank(big, small, cfg5):
  """The three PageRank cases; returns the two urand graphs' SparseArrays
  and float64 ranks, by label."""
  held = {"urand 2^22": pagerank_case("urand 2^22", big, "win",
                                      "csr_launches"),
          "urand 32768": pagerank_case("urand 32768", small, "ell",
                                       "ell_launches")}
  pagerank_case("config-5 blocks", cfg5, "bsr", None, stochastic=False)
  return held

# -- SpMM and ALS ---------------------------------------------------------------

def user_lengths(rng) -> np.ndarray:
  """Ratings per user: ML_MIN_USER plus a power-law tail
  c·(r^-a - n^-a) over the ranks r = 1..n, which runs from ML_MAX_USER at
  rank 1 down to ML_MIN_USER at rank n, with a set so that the lengths sum
  to ML_RATINGS; the ranks are shuffled over the users."""
  n = ML_USERS
  ranks = np.arange(1, n + 1, dtype=np.float64)
  extra = ML_RATINGS - ML_MIN_USER * n

  def tail(a: float) -> np.ndarray:
    c = (ML_MAX_USER - ML_MIN_USER) / (1.0 - n ** -a)
    return np.floor(np.maximum(c * (ranks ** -a - n ** -a), 0)).astype(
        np.int64)

  lo, hi = 0.1, 2.0  # the tail's sum falls as a rises past 0.1
  for _ in range(60):
    mid = (lo + hi) / 2
    if tail(mid).sum() > extra:
      lo = mid
    else:
      hi = mid
  lengths = ML_MIN_USER + tail(hi)
  lengths[1:1 + extra - int(lengths.sum() - ML_MIN_USER * n)] += 1
  return rng.permutation(lengths)


def movielens_shaped(device, seed: int = 0):
  """A float32 scipy CSR ratings matrix of MovieLens 20M's shape, drawn on
  the card from ``seed``: user row lengths from :func:`user_lengths`; each
  user's movies drawn without replacement (so no duplicates) with
  Zipf-like popularity weights 1/(rank + j0), by the smallest of
  Exp(1)/weight keys; j0 set by bisection so that the most popular movie
  is rated by about ML_TOP_MOVIE of the users (estimated on 8192 users
  with fixed keys); popularity ranks shuffled over the movie ids; ratings
  0.5..5.0 from ML_RATING_WEIGHTS."""
  rng = np.random.default_rng(seed)
  lengths = user_lengths(rng)
  gen = torch.Generator(device=device).manual_seed(seed)
  L = torch.from_numpy(lengths).to(device)
  rank = torch.arange(ML_MOVIES, device=device, dtype=torch.float64)
  probe = torch.randperm(ML_USERS, generator=gen, device=device)[:8192]
  probe_keys = torch.empty((probe.shape[0], ML_MOVIES),
                           device=device).exponential_(generator=gen)

  def top_share(j0: float) -> float:
    keys = probe_keys * (rank + j0).float()
    return float(((keys < keys[:, :1]).sum(1) < L[probe]).double().mean())

  lo, hi = 1.0, 1e5  # a larger offset flattens the popularity
  for _ in range(40):
    mid = (lo * hi) ** 0.5
    if top_share(mid) * ML_USERS > ML_TOP_MOVIE:
      lo = mid
    else:
      hi = mid
  inv_weight = (rank + (lo * hi) ** 0.5).float()
  del probe_keys
  movie_of_rank = torch.randperm(ML_MOVIES, generator=gen, device=device)
  chunks = []
  for start in range(0, ML_USERS, 4096):
    Lc = L[start:start + 4096]
    width = int(Lc.max())
    keys = torch.empty((Lc.shape[0], ML_MOVIES), device=device).exponential_(
        generator=gen) * inv_weight
    ids = movie_of_rank[torch.sort(keys, dim=1).indices[:, :width]]
    keep = torch.arange(width, device=device) < Lc[:, None]
    ids = torch.where(keep, ids, ML_MOVIES).sort(dim=1).values
    chunks.append(ids[ids < ML_MOVIES].int())
    del keys, ids, keep
  indices = torch.cat(chunks)
  cdf = torch.tensor(np.cumsum(ML_RATING_WEIGHTS) / sum(ML_RATING_WEIGHTS),
                     device=device, dtype=torch.float32)
  draws = torch.rand(ML_RATINGS, generator=gen, device=device)
  data = (torch.searchsorted(cdf, draws, right=True).clamp_max(9).float()
          + 1) * 0.5
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  return ss.csr_matrix((data.cpu().numpy(), indices.cpu().numpy(), indptr),
                       shape=(ML_USERS, ML_MOVIES))


def skewed_csr():
  """The float32 scipy CSR matrix of SKEW_ROWS, seeded."""
  rng = np.random.default_rng(47)
  lengths = rng.integers(0, 41, SKEW_N)
  for row, length in SKEW_ROWS.items():
    lengths[row] = length
  cols = np.concatenate([np.sort(rng.choice(SKEW_M, length, replace=False))
                         for length in lengths]).astype(np.int32)
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  data = rng.standard_normal(indptr[-1]).astype(np.float32)
  return ss.csr_matrix((data, cols, indptr), shape=(SKEW_N, SKEW_M))


# Two float32 sums of the same n random-signed terms t in another order:
# the rounding errors add like a random walk, so they differ by about
# 0.8·sqrt(n)·2^-24·sqrt(Σt²) (one standard deviation) for sequential sums.
# STAT_C is that bound's multiple, about three times the largest share read
# over the 2^30 entries of the 32768^2 product (PERF.md §6).  Up to
# STAT_C/2 + 1 terms it is no looser than the worst case.
STAT_C = 16.0


def sum_bound(terms, abs_sum, sq_sum, worst):
  """The smaller of the worst case worst·n·2^-24·Σ|t| and the random-walk
  bound STAT_C·sqrt(n)·2^-24·sqrt(Σt²)."""
  return torch.minimum(worst * terms * 2.0 ** -24 * abs_sum,
                       STAT_C * terms ** 0.5 * 2.0 ** -24 * sq_sum.sqrt())


def spmm_tolerance(indptr, indices, data, B):
  """Per entry the smaller of 2·len(row)·2^-24·Σ|a_p·b_p,c| (both sides
  sum the same rounded float32 products, in another order) and the
  random-walk bound on Σ(a_p·b_p,c)² (sum_bound)."""
  lengths = (indptr[1:] - indptr[:-1]).double()[:, None]
  Bf = B.float()
  sum_abs = K5.spmm_csr_plain(indptr, indices, data.abs(), Bf.abs())
  sum_sq = K5.spmm_csr_plain(indptr, indices, data.square(), Bf.square())
  return sum_bound(lengths, sum_abs.double(), sum_sq.double(), 2.0)


def drop_partials(csr, B, got, want, tol):
  """The check's power on K5a's split rows: for the longest row, ``got``
  without that row's partial rows after the first 32 (one step of pass 2
  at k = 64: a pass 2 that stopped there), and ``got`` without its last
  segment.  Returns the row, its segments and each mutant's worst share
  of the row's bound (above 1: the check rejects it)."""
  indptr, indices, data = csr
  r = int((indptr[1:] - indptr[:-1]).argmax())
  s, e = int(indptr[r]), int(indptr[r + 1])
  segs = -(-(e - s) // K5.SEG)

  def without(lo, hi):
    part = (data[lo:hi].double()[:, None]
            * B.double()[indices[lo:hi].long()]).sum(0)
    bad = got[r].double() - part
    return float(((bad - want[r].double()).abs() / tol[r]).max())

  return (r, segs, without(min(e, s + 33 * K5.SEG), e),
          without(s + (segs - 1) * K5.SEG, e))


def spmm_check(label, csr, B):
  """K5a against its plain version on ``csr`` and ``B``; returns the worst
  |kernel - plain|."""
  got = K5.spmm_csr(*csr, B)
  again = K5.spmm_csr(*csr, B)
  want = K5.spmm_csr_plain(*csr, B)
  torch.cuda.synchronize()
  diff = (got.double() - want.double()).abs()
  tol = spmm_tolerance(*csr, B)
  err = float(diff.max()) if diff.numel() else 0.0
  ratio = float((diff / tol.clamp_min(1e-300)).max()) if diff.numel() else 0.0
  same = bool(torch.equal(got, again))
  print(f"  spmm_csr {label}: max|kernel-plain| {err:.3g}, worst share of "
        f"the per-entry bound (spmm_tolerance) {ratio:.3g}; repeat "
        f"bitwise equal: {same}")
  check(got.dtype == torch.promote_types(torch.float32, B.dtype)
        and bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
        f"spmm_csr disagrees with its plain version on {label}")
  check(same, f"spmm_csr is not deterministic on {label}")
  return err


def ingest_ratings(R):
  """sparse.from_scipy(R, dtype=float32) as ALS's caller does, and the
  route set-up both products need (transpose, block test, CSR forms)."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with Timer() as t_ingest:
    S = sparse.from_scipy(R, dtype=np.float32)
    torch.cuda.synchronize()
  with Timer() as t_route:
    fmts = (sparse.spmm_expr(S, sp.zeros((ML_MOVIES, ALS_K))).fmt,
            sparse.spmm_expr(S.T, sp.zeros((ML_USERS, ALS_K))).fmt)
    torch.cuda.synchronize()
  print(f"  ratings: {S.shape[0]} users x {S.shape[1]} movies, nnz "
        f"{S.nnz} ({S.nnz / ML_RATINGS - 1:+.4%} of {ML_RATINGS}), longest "
        f"user row {S.max_nnz_per_row}, most-rated movie "
        f"{S.T.max_nnz_per_row}, fewest per user "
        f"{int(np.diff(R.indptr).min())}; from_scipy {t_ingest.elapsed:.2f} s, "
        f"route set-up (transpose, block test, CSR forms) "
        f"{t_route.elapsed:.2f} s; padded ELL of R and R.T "
        f"{(S.cols.numel() + S.T.cols.numel()) * 8 / 1e9:.2f} GB; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; SpMMExpr "
        f"fmts {fmts}")
  check(fmts == ("winmm", "winmm"), f"ALS's products took {fmts}, not winmm")
  check(abs(S.nnz - ML_RATINGS) <= 0.01 * ML_RATINGS,
        f"nnz {S.nnz} is not within 1 % of {ML_RATINGS}")
  return S


def phase_spmm_kernel(device, card: str, S):
  """K5a against its plain version on the card, then both ALS products
  timed beside the plain version and cuSPARSE."""
  gen = torch.Generator(device=device).manual_seed(5)
  worst = 0.0
  for label, A in small_cases():
    csr = sparse.from_scipy(A).to_csr()
    m = A.shape[1]
    for k in SPMM_KS:
      B = torch.randn(m, k, generator=gen, device=device)
      worst = max(worst, spmm_check(f"{label} k={k}", csr, B))
    B = torch.randn(m, 64, generator=gen, device=device)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
      worst = max(worst, spmm_check(f"{label} k=64 {str(dtype)[6:]} B", csr,
                                    B.to(dtype)))
    Bt = torch.randn(64, m, generator=gen, device=device)
    worst = max(worst, spmm_check(f"{label} k=64 B a transposed view", csr,
                                  Bt.t()))
  # rows split into segments of K5.SEG: every k, every type of B
  csr = sparse.from_scipy(skewed_csr()).to_csr()
  label = f"skewed {SKEW_N}x{SKEW_M} (rows of {sorted(SKEW_ROWS.values())})"
  for k in SKEW_KS:
    B = torch.randn(SKEW_M, k, generator=gen, device=device)
    worst = max(worst, spmm_check(f"{label} k={k}", csr, B))
  for dtype in (torch.bfloat16, torch.float16, torch.float64):
    worst = max(worst, spmm_check(f"{label} k=64 {str(dtype)[6:]} B", csr,
                                  B[:, :64].to(dtype)))
  Bt = torch.randn(64, SKEW_M, generator=gen, device=device)
  worst = max(worst, spmm_check(f"{label} k=64 B a transposed view", csr,
                                Bt.t()))
  B = torch.randn(SKEW_M, ALS_K, generator=gen, device=device)
  got, want = K5.spmm_csr(*csr, B), K5.spmm_csr_plain(*csr, B)
  row, segs, share_tail, share_seg = drop_partials(
      csr, B, got, want, spmm_tolerance(*csr, B))
  print(f"  spmm_csr check's power on {label} k={ALS_K}: row {row} "
        f"({segs} segments) without its partials after the first 32 is "
        f"off by {share_tail:.4g}x its bound, without its last segment by "
        f"{share_seg:.4g}x")
  check(segs > 33 and min(share_tail, share_seg) > 1.0,
        f"spmm_csr's check on {label} passes a result that lost partial "
        f"rows")
  del B, Bt, csr, got, want
  products = (("R @ V", S, ML_MOVIES), ("R.T @ U", S.T, ML_USERS))
  total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
  per_product = {}
  bytes_all = flops_all = 0.0
  for label, A, m in products:
    csr = A.to_csr()
    B = torch.randn(m, ALS_K, generator=gen, device=device)
    worst = max(worst, spmm_check(f"ML-20M {label} k={ALS_K}", csr, B))
    n, nnz = A.shape[0], A.nnz
    lib = torch.sparse_csr_tensor(csr[0].int(), csr[1], csr[2], size=A.shape,
                                  check_invariants=False)
    t = time_in_turns({"plain": lambda: K5.spmm_csr_plain(*csr, B),
                       "kernel": lambda: K5.spmm_csr(*csr, B),
                       "cuSPARSE": lambda: lib @ B}, 3)
    nbytes = nnz * 8 + (n + 1) * 8 + (m + n) * ALS_K * 4
    flops = 2 * nnz * ALS_K
    bound_ms, bound_by = bound(nbytes, flops)
    segments = int(K5.segment_table(csr[0])[-1])
    gathered = nnz * ALS_K * 4  # a row of B a nonzero, from L2
    print(f"  spmm_csr time on ML-20M {label} (n={n}, nnz={nnz}, longest row "
          f"{A.max_nnz_per_row}, {segments} segments of at most {K5.SEG} "
          f"(grid {K5.grid_segments(n, nnz)} warps), gathered rows of B "
          f"{gathered / 1e9:.3f} GB, k={ALS_K}): kernel {t['kernel']:.4f} ms "
          f"({nnz / t['kernel'] / 1e6:.2f} Gnnz/s, "
          f"{flops / t['kernel'] / 1e6:.1f} GFLOP/s, gathers "
          f"{gathered / t['kernel'] / 1e9:.1f} TB/s; "
          f"{t['kernel'] / t['cuSPARSE']:.3f}x cuSPARSE, its work table "
          f"built in the call), plain "
          f"{t['plain']:.4f} ms, cuSPARSE {t['cuSPARSE']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP) (median of {TIMING_REPS} x 3 calls "
          f"queued ahead of the device, CUDA events, in turns; queued ahead: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuSPARSE'))})"
          f"; host issue per call: kernel {t['kernel host']:.4f} ms, plain "
          f"{t['plain host']:.4f} ms, cuSPARSE {t['cuSPARSE host']:.4f} ms; "
          f"on {card}")
    per_product[label] = t["kernel"]
    for key, name in (("ms", "kernel"), ("plain_ms", "plain"),
                      ("library_ms", "cuSPARSE")):
      total[key] += t[name]
    total["bound_ms"] += bound_ms
    bytes_all += nbytes
    flops_all += flops
    del lib, B
  # the row reports one ALS iteration's two products
  _, total["bound_by"] = bound(bytes_all, flops_all)
  total["max_abs_err"] = worst
  print(f"  spmm_csr both products: kernel {total['ms']:.4f} ms "
        f"({total['ms'] / total['library_ms']:.3f}x cuSPARSE), plain "
        f"{total['plain_ms']:.4f} ms, cuSPARSE {total['library_ms']:.4f} ms, "
        f"bound {total['bound_ms']:.4f} ms; worst |kernel-plain| {worst:.3g}"
        f"; R.T @ U over R @ V (the same nonzeros) "
        f"{per_product['R.T @ U'] / per_product['R @ V']:.3f}x")
  return total


def scipy_als(R, U, V):
  """float64 ALS in numpy/scipy from factors U, V; returns them and the
  largest condition number of the Gram matrices it solved with."""
  R64 = R.astype(np.float64)
  R64t = R64.T.tocsr()
  eye = ALS_REG * np.eye(ALS_K)
  cond = 0.0
  for _ in range(ALS_ITERS):
    gram_v = V.T @ V + eye
    U = np.linalg.solve(gram_v, (R64 @ V).T).T
    gram_u = U.T @ U + eye
    V = np.linalg.solve(gram_u, (R64t @ U).T).T
    cond = max(cond, np.linalg.cond(gram_v), np.linalg.cond(gram_u))
  return U, V, cond


def stored_rmse(S, U, V) -> float:
  """RMSE of U @ V.T over the stored ratings, on the card in float64."""
  indptr, indices, data = S.to_csr()
  rows = torch.repeat_interleave(
      torch.arange(S.shape[0], device=indptr.device), indptr[1:] - indptr[:-1],
      output_size=S.nnz)
  Ut = torch.from_numpy(U).to(indptr.device)
  Vt = torch.from_numpy(V).to(indptr.device)
  sse = 0.0
  for lo in range(0, S.nnz, 1 << 21):
    hi = min(lo + (1 << 21), S.nnz)
    pred = (Ut[rows[lo:hi]] * Vt[indices[lo:hi].long()]).sum(1)
    sse += float(((data[lo:hi].double() - pred) ** 2).sum())
  return (sse / S.nnz) ** 0.5


def device_share(fn, tries: int = 3):
  """(device-busy ms by kernel name, summed device ms, wall ms) of one call
  of ``fn`` under torch.profiler (device events only: kernels and
  copies).  The profiled window reaches 20 ms past the timed call on either
  side, since the profiler drops device events it places outside its window;
  a profile that still holds no device event is taken again, ``tries``
  times in all, and after that the summed device ms is None (not
  measured)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  for _ in range(tries):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      time.sleep(0.02)
      with Timer() as t_wall:
        fn()
        torch.cuda.synchronize()
      time.sleep(0.02)
    by_name = {}
    for ev in prof.key_averages():
      if ev.device_type == DeviceType.CUDA:
        by_name[ev.key] = ev.self_device_time_total / 1e3
    if by_name:
      return by_name, sum(by_name.values()), t_wall.elapsed * 1e3
  print(f"  torch.profiler recorded no device event in {tries} profiles")
  return {}, None, t_wall.elapsed * 1e3


def phase_als(R, S):
  """als.fit at full width against a float64 scipy ALS; returns K5a's
  launches in that fit, and the factors, the float64 factors and the
  tolerance that phase 14 holds sharded ALS to."""
  torch.cuda.synchronize()
  with Timer() as t_fit:
    U, V = als.fit(S, k=ALS_K, iterations=ALS_ITERS, reg=ALS_REG, seed=0)
  launches, plain_runs = K5.counts["launches"], K5.counts["plain_runs"]
  check(launches == 2 * ALS_ITERS and plain_runs == 0,
        f"ALS launched K5a {launches} times and ran its plain version "
        f"{plain_runs} times; expected {2 * ALS_ITERS} and 0")
  rng = np.random.default_rng(0)
  U0 = rng.standard_normal((ML_USERS, ALS_K)) * 0.1
  V0 = rng.standard_normal((ML_MOVIES, ALS_K)) * 0.1
  with Timer() as t_oracle:
    U64, V64, cond = scipy_als(R, U0, V0)
  err_u = np.abs(U - U64).max() / np.abs(U64).max()
  err_v = np.abs(V - V64).max() / np.abs(V64).max()
  # float32 products within about 2e-5 of their size (sqrt(len)·2^-24 at
  # rows of up to 70 k ratings), amplified by the Gram solves' condition
  # number (first order)
  tol = cond * 2e-5
  rmse, rmse64 = stored_rmse(S, U, V), stored_rmse(S, U64, V64)
  print(f"  als.fit k={ALS_K}, {ALS_ITERS} iterations, reg {ALS_REG}: "
        f"{t_fit.elapsed / ALS_ITERS * 1e3:.1f} ms/iteration (host clock, "
        f"synced, first call included); K5a launches {launches}; max rel "
        f"err vs float64 scipy ALS: U {err_u:.3g}, V {err_v:.3g} (tolerance "
        f"largest Gram condition number {cond:.4g} x 2e-5 = {tol:.3g}); "
        f"RMSE over the stored ratings {rmse:.6f} (float64 ALS "
        f"{rmse64:.6f}); scipy ALS {t_oracle.elapsed:.1f} s")
  check(U.shape == (ML_USERS, ALS_K) and V.shape == (ML_MOVIES, ALS_K)
        and bool(np.isfinite(U).all() and np.isfinite(V).all()),
        "ALS factors are not finite or of the wrong shape")
  check(max(err_u, err_v) <= tol, "ALS disagrees with the float64 ALS")
  with Timer() as t_steady:
    als.fit(S, k=ALS_K, iterations=ALS_ITERS, reg=ALS_REG, seed=0)
  # the pieces of an iteration: a product with its transfers, a host solve
  sv = sp.from_numpy(V)
  np.asarray(sp.dot(S, sv).glom())
  with Timer() as t_product:
    rv = np.asarray(sp.dot(S, sp.from_numpy(V)).glom())
  gram = np.asarray(sp.dot(sv.T, sv).glom()) + ALS_REG * np.eye(ALS_K)
  with Timer() as t_solve:
    np.linalg.solve(gram, rv.T)
  print(f"  an iteration's pieces (host clock): R @ V with V's upload and "
        f"the result's download {t_product.elapsed * 1e3:.1f} ms, the host "
        f"solve for U {t_solve.elapsed * 1e3:.1f} ms")
  by_name, busy, wall = device_share(
      lambda: als.fit(S, k=ALS_K, iterations=1, reg=ALS_REG, seed=0))
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
  share = ("device busy not measured" if busy is None else
           f"device busy {busy:.2f} ms (idle share {1 - busy / wall:.3f})")
  print(f"  als.fit steady {t_steady.elapsed / ALS_ITERS * 1e3:.1f} "
        f"ms/iteration (host clock, synced); one iteration under "
        f"torch.profiler: wall {wall:.1f} ms, {share}; by kernel (ms): "
        + ", ".join(f"{name[:48]} {ms:.3f}" for name, ms in top))
  return launches, (U, V, U64, V64, tol)


# -- stencils, heat, Jacobi-Poisson, convnet -----------------------------------

# unit roundoff of the kernels' types (2^-p, p the significand's bits)
UNIT = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
        torch.float16: 2.0 ** -11}


def stencil_tol(dtype, coeffs, steps, x_max, add_max=0.0) -> float:
  """0 in float32: kernel and plain version round the same ops in the same
  order.  In bfloat16/float16 the bound of two roundings apart per op: per
  step 2·(taps + 1)·u of the largest Σ|c·x| + |add| it reaches, grown by
  the gain Σ|c| of each later step."""
  if dtype == torch.float32:
    return 0.0
  gain = sum(abs(c) for c in coeffs)
  taps = sum(c != 0.0 for c in coeffs)
  scale, worst = x_max, 0.0
  for _ in range(steps):
    scale = gain * scale + add_max
    worst = max(worst, scale)
  return (2 * (taps + 1) * UNIT[dtype] * steps * worst
          * max(gain, 1.0) ** (steps - 1))


def ring(xp: torch.Tensor) -> torch.Tensor:
  """The pad ring of a padded array, flattened."""
  mask = torch.ones(xp.shape, dtype=torch.bool, device=xp.device)
  mask[K6.PAD_R:-K6.PAD_R, K6.PAD_C:-K6.PAD_C] = False
  return xp[mask]


def phase_stencil_kernels(device, card: str):
  """K4 and K6a against their plain versions on the card, then timed at
  16384^2 float32 beside their plain versions and cuDNN."""
  gen = torch.Generator(device=device).manual_seed(17)
  worst = {"stencil3x3": 0.0, "stencil3x3_padded": 0.0}
  n_cases = {"stencil3x3": 0, "stencil3x3_padded": 0}
  for shape in STENCIL_SHAPES:
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
      bitwise = {"stencil3x3": True, "stencil3x3_padded": True}
      ratio = {"stencil3x3": 0.0, "stencil3x3_padded": 0.0}
      for coeffs in (LAPLACIAN, NINE):
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        g = torch.randn(shape, generator=gen, device=device).to(dtype)
        x_max = float(x.abs().max())
        cases = [("stencil3x3", K6.stencil3x3(x, coeffs),
                  K6.stencil3x3_plain(x, coeffs),
                  stencil_tol(dtype, coeffs, 1, x_max))]
        xp, gp = K6.to_padded(x), K6.to_padded(g)
        for add in (None, gp):
          add_max = float(g.abs().max()) if add is not None else 0.0
          for steps in (1, 2, 3):
            # a NaN ring on buf shows the kernel never writes it; after
            # one step buf holds the result, so its ring must stay NaN
            buf = torch.full_like(xp, float("nan")) if steps == 1 else (
                torch.zeros_like(xp))
            got, _ = K6.stencil3x3_padded(xp.clone(), buf, coeffs, steps,
                                          add)
            want, _ = K6.stencil3x3_padded_plain(
                xp.clone(), buf.clone(), coeffs, steps, add)
            check(bool(ring(got).isnan().all()) if steps == 1 else
                  not bool(ring(got).any()),
                  f"K6a wrote the ring of its output ({shape}, {steps})")
            cases.append(("stencil3x3_padded", K6.from_padded(got),
                          K6.from_padded(want),
                          stencil_tol(dtype, coeffs, steps, x_max, add_max)))
        for name, got, want, tol in cases:
          torch.cuda.synchronize()
          diff = (got.double() - want.double()).abs()
          err = float(diff.max())
          check(got.dtype == dtype and got.shape == want.shape
                and bool(torch.isfinite(got).all()) and err <= tol,
                f"{name} disagrees with its plain version on {shape} "
                f"{dtype}: max|diff| {err:.3g} > {tol:.3g}")
          worst[name] = max(worst[name], err)
          bitwise[name] = bitwise[name] and bool(torch.equal(got, want))
          ratio[name] = max(ratio[name], err / tol if tol else 0.0)
          n_cases[name] += 1
      for name in ("stencil3x3", "stencil3x3_padded"):
        rule = ("bit for bit" if dtype == torch.float32 else
                f"worst share of the bound 2(taps+1)u per step {ratio[name]:.3g}")
        print(f"  {name:17s} {str(shape):13s} {str(dtype)[6:]:8s} laplacian "
              f"and nine taps{', add and no add, steps 1-3' if 'padded' in name else ''}: "
              f"equal to the plain version {rule}; bitwise equal: "
              f"{bitwise[name]}")
      check(dtype != torch.float32 or all(bitwise.values()),
            f"a stencil kernel is not bit-equal to its plain version in "
            f"float32 on {shape}")
  launches = dict(K6.counts)
  print(f"  cases: {n_cases}; counts {launches}")
  check(launches["k4_launches"] == n_cases["stencil3x3"]
        and launches["k6a_launches"] == 2 * 2 * 6 * len(STENCIL_SHAPES) * 3
        and launches["plain_runs"] == launches["routed_plain"] == 0,
        f"unexpected stencil counts {launches}")
  x64 = torch.randn(13, 20, device=device, dtype=torch.float64)
  K6.stencil3x3(x64, NINE)
  check(K6.counts["routed_plain"] == 1 and K6.counts["k4_launches"]
        == launches["k4_launches"], "float64 did not take the plain route")

  # time at 16384^2 float32: the heat and Jacobi coefficients (K6a's main
  # path), the Laplacian for K4; cuDNN's F.conv2d with TF32 off as the
  # library call (plus the add for K6a's add form)
  torch.backends.cudnn.allow_tf32 = False
  n = GRID_N
  x = torch.rand((n, n), generator=gen, device=device)
  g = torch.randn((n, n), generator=gen, device=device)
  xp, gp, buf = K6.to_padded(x), K6.to_padded(g), torch.zeros(
      K6.padded_shape(n, n), device=device)
  x4, g4 = x[None, None], g[None, None]

  def weights(coeffs):
    return torch.tensor(coeffs, device=device).view(1, 1, 3, 3)

  w_lap, w_heat, w_jac = weights(LAPLACIAN), weights(HEAT), weights(JACOBI)
  timed = {
      "stencil3x3": ("Laplacian", 2, {
          "plain": lambda: K6.stencil3x3_plain(x, LAPLACIAN),
          "kernel": lambda: K6.stencil3x3(x, LAPLACIAN),
          "cuDNN": lambda: F.conv2d(x4, w_lap, padding=1)}),
      "padded": ("heat", 2, {
          "plain": lambda: K6.stencil3x3_padded_plain(xp, buf, HEAT),
          "kernel": lambda: K6.stencil3x3_padded(xp, buf, HEAT),
          "cuDNN": lambda: F.conv2d(x4, w_heat, padding=1)}),
      "padded add": ("Jacobi", 3, {
          "plain": lambda: K6.stencil3x3_padded_plain(xp, buf, JACOBI,
                                                      add=gp),
          "kernel": lambda: K6.stencil3x3_padded(xp, buf, JACOBI, add=gp),
          "cuDNN": lambda: F.conv2d(x4, w_jac, padding=1).add_(g4)}),
  }
  rows = {}
  for label, (cname, fields, fns) in timed.items():
    t = time_in_turns(fns)
    coeffs = {"Laplacian": LAPLACIAN, "heat": HEAT, "Jacobi": JACOBI}[cname]
    nbytes = fields * n * n * 4
    flops = 2 * sum(c != 0.0 for c in coeffs) * n * n
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  {label} ({cname} taps) at {n}^2 float32: kernel "
          f"{t['kernel']:.4f} ms ({nbytes / t['kernel'] / 1e6:.1f} GB/s), "
          f"plain {t['plain']:.4f} ms, cuDNN conv2d"
          f"{' + add' if fields == 3 else ''} {t['cuDNN']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB) (median of "
          f"{TIMING_REPS}, queued ahead of the device: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuDNN'))}, "
          f"CUDA events, in turns); host issue per call: kernel "
          f"{t['kernel host']:.4f} ms; on {card}")
    rows[label] = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t["cuDNN"], "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes, "flops": flops}
  k4 = dict(rows["stencil3x3"], max_abs_err=worst["stencil3x3"],
            launches=launches["k4_launches"])
  # K6a's row: one heat sweep plus one Jacobi sweep, its two forms on the
  # path
  k6a = {key: rows["padded"][key] + rows["padded add"][key]
         for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes",
                     "flops")}
  k6a.update(bound_by=bound(k6a["bytes"], k6a["flops"])[1],
             max_abs_err=worst["stencil3x3_padded"])
  return k4, k6a


def heat_oracle(u0: torch.Tensor, iters: int, alpha: float):
  """simulate_numpy's iteration in float64 torch on the card."""
  u = u0.double()
  for _ in range(iters):
    up = F.pad(u, (1, 1, 1, 1))
    u = u + alpha * (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2]
                     + up[1:-1, 2:] - 4.0 * u)
  return u


def jacobi_oracle(f: torch.Tensor, iters: int, h: float = 1.0):
  """solve_jacobi_numpy's iteration in float64 torch on the card; returns
  u and the sum over sweeps of max|u| + max|h^2 f / 4|."""
  f = f.double()
  u = torch.zeros_like(f)
  g_max = float((h * h / 4.0) * f.abs().max())
  scale = 0.0
  for _ in range(iters):
    up = F.pad(u, (1, 1, 1, 1))
    u = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
         ) / 4.0 - (h * h / 4.0) * f
    scale += float(u.abs().max()) + g_max
  return u, scale


def conv_numpy(x: np.ndarray, w: np.ndarray) -> np.ndarray:
  """'SAME' 3x3 stride-1 cross-correlation, NCHW by OIHW, in float64."""
  _, _, h, wd = x.shape
  xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
  return sum(np.einsum("nchw,oc->nohw", xp[:, :, di:di + h, dj:dj + wd],
                       w[:, :, di, dj])
             for di in range(3) for dj in range(3))


def convnet_numpy(images: np.ndarray, params) -> np.ndarray:
  def pool(v):
    n, c, h, w = v.shape
    return v.reshape(n, c, h // 2, 2, w // 2, 2).max(axis=(3, 5))
  h1 = pool(np.maximum(conv_numpy(images, params["w1"]), 0.0))
  h2 = pool(np.maximum(conv_numpy(h1, params["w2"]), 0.0))
  return h2.reshape(len(h2), -1) @ params["wd"] + params["bd"]


def padded_sweeps(label, run, oracle, device):
  """Run the entry point ``run`` (returns numpy) and hold it against
  ``oracle`` (returns the float64 field and the tolerance)."""
  before = K6.counts["k6a_launches"]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  held = torch.cuda.memory_allocated()
  with Timer() as t_run:
    got = run()
  peak = torch.cuda.max_memory_allocated() - held
  launches = K6.counts["k6a_launches"] - before
  with Timer() as t_oracle:
    want, tol = oracle()
  got_t = torch.from_numpy(got).to(device)
  err = float((got_t.double() - want).abs().max())
  n = GRID_N
  print(f"  {label} {n}^2 float32, {SWEEPS} sweeps: K6a launches {launches}; "
        f"max|u - u64| {err:.4g} (tolerance {tol:.4g}); entry point wall "
        f"{t_run.elapsed:.3f} s ({t_run.elapsed / SWEEPS * 1e3:.4f} ms a "
        f"sweep with set-up and the result's copy to the host, host clock, "
        f"synced); peak device memory {peak / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB held before; float64 oracle on the card "
        f"{t_oracle.elapsed:.2f} s")
  check(got.shape == (n, n) and got.dtype == np.float32
        and bool(torch.isfinite(got_t).all()), f"{label}: bad field")
  check(launches == SWEEPS, f"{label}: K6a launched {launches} times, "
        f"expected {SWEEPS}")
  check(err <= tol, f"{label} disagrees with its float64 oracle")
  del got_t, want
  return got


def sweep_profile(label, coeffs, fields, state, add, card: str):
  """Device time and idle share of one chunk of CHUNK sweeps through the
  wrapper, under torch.profiler; K6a's time by CUDA events where the
  profiler recorded no device event."""
  xp = K6.to_padded(state)
  buf = torch.zeros_like(xp)

  def chunk():
    K6.stencil3x3_padded(xp, buf, coeffs, CHUNK, add)

  chunk()  # warm
  by_name, busy, wall = device_share(chunk)
  nbytes = fields * GRID_N * GRID_N * 4
  if busy is None:
    kernel_ms = event_ms(chunk)[0] / CHUNK
    share = (f"device busy and idle share not measured; K6a {kernel_ms:.4f} "
             f"ms a sweep by CUDA events")
  else:
    kernel_ms = sum(ms for name, ms in by_name.items()
                    if "stencil3x3" in name) / CHUNK
    check(kernel_ms > 0, f"{label}: the profile shows no K6a device time "
          f"({sorted(by_name)})")
    share = (f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); "
             f"K6a {kernel_ms:.4f} ms a sweep")
  print(f"  {label}: one chunk of {CHUNK} sweeps under torch.profiler: wall "
        f"{wall:.3f} ms, {share}, {nbytes / kernel_ms / 1e6:.1f} GB/s "
        f"effective ({fields} x n^2 x 4 bytes); on {card}")


def phase_stencil_path(device, card: str):
  """heat.simulate_padded and poisson.solve_jacobi at 16384^2 float32,
  heat.simulate at 4096^2 float64, convnet at MNIST's test-set shape;
  returns K6a's launches on the padded path, and the heat sweeps' initial
  field (on the card) and result (numpy) for phase 14."""
  gen = torch.Generator(device=device).manual_seed(23)
  n = GRID_N
  u0 = torch.rand((n, n), generator=gen, device=device)
  f = torch.randn((n, n), generator=gen, device=device)
  K6.reset_counts()  # count the padded path's launches only
  # heat: gain 1 (non-negative coefficients summing to 1 for alpha <=
  # 0.25), so max|u| never exceeds max|u0| and each sweep adds at most
  # 2(taps + 1) roundings of 2^-24 max|u0| (the float32 coefficients'
  # own rounding among them)
  heat_result = padded_sweeps(
      "heat.simulate_padded",
      lambda: heat.simulate_padded(u0, iters=SWEEPS, alpha=HEAT_ALPHA),
      lambda: (heat_oracle(u0, SWEEPS, HEAT_ALPHA),
               SWEEPS * 2 * 6 * 2.0 ** -24 * float(u0.abs().max())),
      device)

  # Jacobi: gain 1, so the sweeps' roundings add up: per sweep 2(taps + 1)
  # 2^-24 of max|u| + max|h^2 f/4| (0.25 and the field -f/4 are exact)
  def jacobi():
    u, scale = jacobi_oracle(f, SWEEPS)
    return u, 2 * 5 * 2.0 ** -24 * scale

  padded_sweeps("poisson.solve_jacobi",
                lambda: poisson.solve_jacobi(f, iters=SWEEPS), jacobi, device)
  launches = K6.counts["k6a_launches"]
  check(launches >= 2 * SWEEPS and K6.counts["plain_runs"] == 0
        and K6.counts["routed_plain"] == 0,
        f"the padded path launched K6a {launches} times (counts {K6.counts})")
  sweep_profile("heat", HEAT, 2, u0, None, card)
  sweep_profile("Jacobi", JACOBI, 3, torch.zeros_like(f),
                K6.to_padded(-0.25 * f), card)
  del f

  # the expression path: make_fori over StencilExpr and ReshapeExpr
  rng = np.random.default_rng(29)
  v0 = rng.random((EXPR_N, EXPR_N))
  torch.cuda.synchronize()
  with Timer() as t_expr:
    got = heat.simulate(v0, iters=EXPR_STEPS, alpha=HEAT_ALPHA).glom()
  with Timer() as t_np:
    want = heat.simulate_numpy(v0, iters=EXPR_STEPS, alpha=HEAT_ALPHA)
  err = float(np.abs(got - want).max())
  print(f"  heat.simulate {EXPR_N}^2 float64, {EXPR_STEPS} steps: max|diff| "
        f"vs simulate_numpy {err:.3g} (tolerance 1e-10 max|u|); "
        f"{t_expr.elapsed:.2f} s with the copies (host clock), numpy "
        f"{t_np.elapsed:.2f} s")
  check(got.dtype == np.float64 and got.shape == (EXPR_N, EXPR_N)
        and err <= 1e-10 * np.abs(want).max(),
        "heat.simulate disagrees with simulate_numpy")

  # convnet's forward pass on MNIST's test-set shape (synthetic images)
  images = rng.random(MNIST_SHAPE)
  params = convnet.init_params()
  torch.cuda.synchronize()
  with Timer() as t_fwd:
    logits = convnet.forward(sp.from_numpy(images), params).glom()
  pred = convnet.predict(sp.from_numpy(images), params).glom()
  want = convnet_numpy(images[:CONV_CHECK], params)
  err = float(np.abs(logits[:CONV_CHECK] - want).max())
  print(f"  convnet.forward {MNIST_SHAPE} float64: {t_fwd.elapsed:.3f} s "
        f"with the copies (host clock); max|logits - numpy| on the first "
        f"{CONV_CHECK} {err:.3g} (tolerance 1e-10 max|logits|); predict "
        f"equals argmax(forward) on all {MNIST_SHAPE[0]}")
  check(logits.shape == (MNIST_SHAPE[0], 10) and logits.dtype == np.float64
        and bool(np.isfinite(logits).all())
        and err <= 1e-10 * np.abs(want).max(),
        "convnet.forward disagrees with the numpy forward")
  check(np.array_equal(pred, logits.argmax(axis=1))
        and np.array_equal(pred[:CONV_CHECK], want.argmax(axis=1)),
        "convnet.predict disagrees with argmax(forward)")
  return launches, (u0, heat_result)


# -- the matrix product K2 -------------------------------------------------------

OUT_UNIT = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}


def relu(acc):
  return torch.clamp_min(acc, 0.0)


def matmul_tol(x, y, want, absprod=None, sqprod=None):
  """Both sides sum the same K exact products in float32 in another order:
  worst case d <= 2·K·2^-24·(|x| @ |y|), doubled because tensor cores may
  truncate inside their adds, or the random-walk bound on x² @ y²,
  whichever is smaller; a 16-bit output rounds each side once more,
  2u·(|want| + d) on top."""
  xf, yf = x.float(), y.float()
  if absprod is None:
    absprod = xf.abs() @ yf.abs()
  if sqprod is None:
    sqprod = xf.square() @ yf.square()
  d = sum_bound(x.shape[1], absprod, sqprod, 4.0)
  return d + 2.0 * OUT_UNIT[x.dtype] * (want.float().abs() + d)


def phase_matmul_kernel(device):
  """K2 against matmul_plain on the card: four shapes, three dtypes, with
  and without the ReLU epilogue (fused), and one epilogue outside the op
  table (unfused); returns the worst |kernel - plain|."""
  check_ptxas("matmul", "hopper_gemm", "K2")
  check_ptxas("matmul", "sgemm", "K2 float32")
  print(f"  K2 16-bit kernel: {K2.TILE_M} x {K2.TILE_N} output tiles, "
        f"{K2.TILE_K}-deep stages, a ring of {K2.STAGES}; float32: "
        f"{K2.SGEMM_TILE_M} x {K2.SGEMM_TILE_N} output tiles, "
        f"{K2.SGEMM_TILE_K}-deep stages, a ring of {K2.SGEMM_STAGES}")
  gen = torch.Generator(device=device).manual_seed(41)
  worst, cases = 0.0, 0
  for m, k, n in MATMUL_SHAPES:
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
      x = torch.randn(m, k, generator=gen, device=device).to(dtype)
      y = torch.randn(k, n, generator=gen, device=device).to(dtype)
      for label, epilogue in (("none", None), ("relu", relu)):
        before = dict(K2.counts)
        got = K2.matmul(x, y, epilogue=epilogue)
        again = K2.matmul(x, y, epilogue=epilogue)
        want = K2.matmul_plain(x, y, epilogue)
        torch.cuda.synchronize()
        # an operand whose rows are not a multiple of 16 bytes is padded
        # first, once a call (TMA reads both in every dtype)
        per16 = 16 // x.element_size()
        padded = 2 * ((k % per16 != 0) + (n % per16 != 0))
        check(K2.counts == dict(before, launches=before["launches"] + 2,
                                padded_operands=before["padded_operands"]
                                + padded),
              f"K2 counts {K2.counts} after {before}: the {label} epilogue "
              f"did not fuse into two launches with {padded} padded operands")
        diff = (got.float() - want.float()).abs()
        tol = matmul_tol(x, y, want)
        share = float((diff / tol.clamp_min(1e-30)).max())
        err = float(diff.max())
        worst = max(worst, err)
        cases += 1
        same = bool(torch.equal(got, again))
        print(f"  K2 {m}x{k}x{n} {str(dtype)[6:]:8s} epilogue {label}: "
              f"max|kernel-plain| {err:.3g}, worst share of the bound "
              f"{share:.3g}; repeat bitwise equal: {same}")
        check(got.dtype == dtype and got.shape == (m, n)
              and bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
              f"K2 disagrees with its plain version: {m}x{k}x{n} {dtype} "
              f"{label}")
        check(same, f"K2 is not deterministic: {m}x{k}x{n} {dtype} {label}")
  x = torch.randn(300, 500, generator=gen, device=device)
  y = torch.randn(500, 200, generator=gen, device=device)
  before = dict(K2.counts)
  got = K2.matmul(x, y, epilogue=torch.tanh)
  want = K2.matmul_plain(x, y, torch.tanh)
  torch.cuda.synchronize()
  check(K2.counts == dict(before, launches=before["launches"] + 1,
                          epilogue_unfused=before["epilogue_unfused"] + 1),
        f"the tanh epilogue was not run unfused after one launch ({K2.counts})")
  err = float((got - want).abs().max())
  check(bool(((got - want).abs() <= matmul_tol(x, y, want)).all()),
        "K2 with an unfused epilogue disagrees with its plain version")
  worst = max(worst, err)
  print(f"  K2 300x500x200 float32 epilogue tanh (outside the op table, run "
        f"in torch on the kernel's float32 product): max|kernel-plain| "
        f"{err:.3g}; {cases + 1} cases, counts {K2.counts}")
  return max(worst, check_new_epilogues(device))


def mod2(acc):
  return acc % 2.0


def abs_pow(acc):
  return torch.abs(acc) ** 1.5


def check_new_epilogues(device):
  """K2's epilogue with % and ** (op-program instructions since the op
  table took them) against matmul_plain at 300x191x520: the product's
  bound carried through the op (for %, the distance on the circle of the
  modulus; for |a|**1.5, its derivative 1.5·|a|**0.5 times the bound, and
  4 ulps of the result); in float32 also against torch's op on the
  kernel's own product, bit for bit for % and at 2 float32 ulps for
  ** (powf on both sides).  Returns the worst |kernel - plain|."""
  gen = torch.Generator(device=device).manual_seed(47)
  worst = 0.0
  for dtype in (torch.float32, torch.bfloat16):
    x = torch.randn(300, 191, generator=gen, device=device).to(dtype)
    y = torch.randn(191, 520, generator=gen, device=device).to(dtype)
    before = dict(K2.counts)
    got = {"%": K2.matmul(x, y, epilogue=mod2),
           "**": K2.matmul(x, y, epilogue=abs_pow)}
    check(K2.counts == dict(before, launches=before["launches"] + 2,
                            padded_operands=before["padded_operands"] + 2),
          f"the % and ** epilogues did not fuse into two launches "
          f"({K2.counts})")
    prod = K2.matmul_plain(x, y)
    tol = matmul_tol(x, y, prod).float()
    unit = max(OUT_UNIT[dtype], 2.0 ** -23)
    want = {"%": K2.matmul_plain(x, y, mod2),
            "**": K2.matmul_plain(x, y, abs_pow)}
    d = (got["%"].float() - want["%"].float()).abs()
    d_mod = torch.minimum(d, 2.0 - d)
    ok_mod = bool((d_mod <= tol + 4.0 * unit).all())
    base = prod.float().abs()
    pow_tol = (1.5 * (base + tol).sqrt() * tol
               + 4.0 * unit * want["**"].float().abs())
    d_pow = (got["**"].float() - want["**"].float()).abs()
    ok_pow = bool((d_pow <= pow_tol).all())
    worst = max(worst, float(d_mod.max()), float(d_pow.max()))
    own = ""
    if dtype == torch.float32:
      mine = K2.matmul(x, y)
      same_mod = bool(torch.equal(got["%"], torch.remainder(mine, 2.0)))
      pow_ulps = float(((got["**"] - torch.abs(mine) ** 1.5).abs()
                        / (torch.abs(mine) ** 1.5).clamp_min(1e-30)).max()
                       / 2.0 ** -23)
      own = (f"; on the kernel's own product: % bit-equal {same_mod}, ** "
             f"within {pow_ulps:.2f} ulps")
      check(same_mod and pow_ulps <= 2.0,
            "K2's % or ** epilogue disagrees with torch on its own product")
    print(f"  K2 300x191x520 {str(dtype)[6:]} epilogues a % 2.0 and "
          f"|a| ** 1.5 (fused): max circular |kernel-plain| "
          f"{float(d_mod.max()):.3g}, max |kernel-plain| for ** "
          f"{float(d_pow.max()):.3g}, within the bound: {ok_mod and ok_pow}"
          f"{own}")
    check(ok_mod and ok_pow,
          f"K2's % or ** epilogue disagrees with matmul_plain ({dtype})")
  return worst


def check_product(x, y, got, want, label: str, block: int = 4096):
  """Holds a full-size K2 product against its reference, ``block`` rows at
  a time, and shows the check's power: the first block without one of the
  kernel's K tiles (SGEMM_TILE_K wide in float32, TILE_K in 16-bit) must
  fail it.
  Returns max|got - want|, the worst share of the bound, the tile and the
  share of that block's entries the check rejects without it."""
  n, dtype = x.shape[1], x.dtype
  ya, y2 = y.float().abs(), y.float().square()
  err, share = 0.0, 0.0
  tile = K2.SGEMM_TILE_K if dtype == torch.float32 else K2.TILE_K
  caught = 0.0
  for lo in range(0, x.shape[0], block):
    xb = x[lo:lo + block].float()
    tol = matmul_tol(x[lo:lo + block], y, want[lo:lo + block],
                     xb.abs() @ ya, xb.square() @ y2)
    d = (got[lo:lo + block].float() - want[lo:lo + block].float()).abs()
    check(bool((d <= tol).all()) and bool(torch.isfinite(got[lo:lo + block])
                                          .all()),
          f"K2 disagrees with {label}: worst share of the bound "
          f"{float((d / tol.clamp_min(1e-30)).max()):.4g}")
    err = max(err, float(d.max()))
    share = max(share, float((d / tol.clamp_min(1e-30)).max()))
    if lo == 0:
      k0 = n // 2 // tile * tile
      bad = (got[:block].float() - xb[:, k0:k0 + tile]
             @ y[k0:k0 + tile].float()).to(dtype).float()
      caught = float(((bad - want[:block].float()).abs() > tol).float()
                     .mean())
      check(caught > 0.5, f"K2's check against {label} passes a product "
            f"that lost one K tile")
      del bad
    del xb, d, tol
  return err, share, tile, caught


def phase_matmul_path(device, card: str):
  """matmul.matmul at config 2's published 32768^2 float32 against
  torch.matmul (TF32 off), and at bench.py's 8192^2 bfloat16 against
  matmul_plain; each timed beside matmul_plain and cuBLAS.  Returns the
  32768^2 row of the kernels line."""
  check(not torch.backends.cuda.matmul.allow_tf32,
        "TF32 is on: the float32 yardstick would not be full float32")
  gen = torch.Generator(device=device).manual_seed(43)
  rows = {}
  block = 4096
  for n, dtype, peak, reps in ((CFG2_N, torch.float32, F32_FLOPS, CFG2_REPS),
                               (BENCH_MM_N, torch.bfloat16, BF16_FLOPS,
                                TIMING_REPS)):
    x = torch.randn(n, n, generator=gen, device=device).to(dtype)
    y = torch.randn(n, n, generator=gen, device=device).to(dtype)
    torch.cuda.synchronize()
    with Timer() as t_call:
      got = K2.matmul(x, y)
      torch.cuda.synchronize()
    ref_name = "torch.matmul" if dtype == torch.float32 else "matmul_plain"
    want = torch.matmul(x, y) if dtype == torch.float32 else K2.matmul_plain(
        x, y)
    err, share, tile, caught = check_product(
        x, y, got, want, f"{ref_name} at {n}^2 {dtype}", block)
    del want
    same = bool(torch.equal(got, K2.matmul(x, y)))
    check(same, f"K2 at {n}^2 {dtype} is not bit-equal on repeat")
    del got
    fns = {"plain": lambda: K2.matmul_plain(x, y),
           "kernel": lambda: K2.matmul(x, y),
           "cuBLAS": lambda: torch.matmul(x, y)}
    t = time_in_turns(fns, reps=reps)
    flops = 2.0 * n ** 3
    nbytes = 3.0 * n * n * x.element_size()
    bound_ms, bound_by = bound(nbytes, flops, peak)
    print(f"  K2 {n}^2 {str(dtype)[6:]}: one call {t_call.elapsed:.3f} s "
          f"(host clock, first at this shape); max|kernel - {ref_name}| "
          f"{err:.4g}, worst share of the bound {share:.3g} (a result "
          f"without one {tile}-wide K tile fails it at {100 * caught:.1f}% "
          f"of the first {block} rows' entries); repeat bitwise equal: "
          f"{same}; kernel "
          f"{t['kernel']:.4f} ms ({flops / t['kernel'] / 1e9:.1f} TFLOP/s), "
          f"matmul_plain {t['plain']:.4f} ms, cuBLAS torch.matmul "
          f"{t['cuBLAS']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(median of {reps}, CUDA events, in turns; queued ahead: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'plain', 'cuBLAS'))}) "
          f"on {card}")
    print(f"  K2 {n}^2 {str(dtype)[6:]}: "
          f"{100 * flops / (t['kernel'] * 1e-3) / peak:.1f} % of "
          f"{peak / 1e12:.0f} TFLOP/s; kernel / cuBLAS "
          f"{t['kernel'] / t['cuBLAS']:.3f} on {card}")
    rows[(n, dtype)] = {"ms": t["kernel"], "plain_ms": t["plain"],
                        "library_ms": t["cuBLAS"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": err}
    del x, y
    torch.cuda.empty_cache()
  return rows


# -- the unique-rows SpMV K3c and make_spmv_windowed ---------------------------

def chunk_cases():
  """K3c's edge cases: no nonzero, fewer than one chunk, chunk boundaries
  on row boundaries, empty rows at both ends, rows longer than 10 chunks,
  runs of empty rows inside chunks, tests/test_kernels.py's heavy-duplicate
  row and its duplicate-summed random matrix."""
  rng = np.random.default_rng(13)
  cases = [("nnz 0", ss.csr_matrix((50, 40), dtype=np.float32)),
           ("below one chunk", ss.random(40, 50, density=0.15, random_state=1,
                                         format="csr", dtype=np.float32))]
  lengths = np.array([512, 512, 1024, 256, 768, 1024, 3])
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  cases.append(("rows on chunk boundaries", ss.csr_matrix(
      (rng.standard_normal(indptr[-1]).astype(np.float32),
       rng.integers(0, 3000, indptr[-1]).astype(np.int32), indptr),
      shape=(len(lengths), 3000))))
  ends = ss.random(300, 700, density=0.05, random_state=2, format="lil",
                   dtype=np.float32)
  ends[:100, :] = 0
  ends[200:, :] = 0
  cases.append(("empty rows at both ends", ends.tocsr()))
  long_rows = ss.random(64, 20000, density=0.001, random_state=3, format="lil",
                        dtype=np.float32)
  for row, count in ((7, 12_000), (8, 15_000)):
    long_rows[row, rng.choice(20000, count, replace=False)] = (
        rng.standard_normal(count).astype(np.float32))
  cases.append(("rows of 12000 and 15000", long_rows.tocsr()))
  cases.append(("empty-row runs in chunks", ss.random(
      200_000, 500, density=2e-5, random_state=4, format="csr",
      dtype=np.float32)))
  dup = ss.lil_matrix((1100, 1100), dtype=np.float32)
  dup[5, 0:200] = rng.standard_normal(200)
  dup[5, 1024:1060] = rng.standard_normal(36)
  cases.append(("heavy duplicates", dup.tocsr()))
  n, m = 3000, 2500
  r, c = rng.integers(0, n, n * 9), rng.integers(0, m, n * 9)
  A = ss.coo_matrix((rng.standard_normal(n * 9).astype(np.float32), (r, c)),
                    shape=(n, m)).tocsr()
  A.sum_duplicates()
  cases.append(("random, duplicates summed", A))
  return cases


def row_tol(indptr, indices, data, x, want):
  """Per row of a CSR matrix the smaller of 2·len·2^-24·Σ|a·x| (float32
  sums of the same products in another order) and the random-walk bound on
  Σ(a·x)², plus one rounding to x's dtype on each side."""
  lengths = (indptr[1:] - indptr[:-1]).float()
  sum_abs = KS.spmv_csr_plain(indptr, indices, data.abs(), x.float().abs())
  sum_sq = KS.spmv_csr_plain(indptr, indices, data.square(),
                             x.float().square())
  return (sum_bound(lengths, sum_abs, sum_sq, 2.0)
          + 2.0 * OUT_UNIT[x.dtype] * want.float().abs())


def drop_chunk_head(packed, x, got, want, tol):
  """The check's power on K3c: ``got`` less one part of a row that the
  kernel adds in a pass of its own.  On a windowed pack, one window's
  partial of the longest row (the window holding most of its products);
  else one chunk's head, the products of the chunk's first row that the
  chunk carries into that row, for the longest row where it crosses a
  chunk boundary, else for the middle chunk.  Returns the row, the part
  dropped, the products in it, |error| and the row's bound."""
  r = int((packed.indptr[1:] - packed.indptr[:-1]).argmax())
  if packed.windows is not None:
    w = packed.windows
    starts, ends = w.indptr[:, r].tolist(), w.indptr[:, r + 1].tolist()
    s = max(range(w.count), key=lambda k: ends[k] - starts[k])
    lo, hi = starts[s], ends[s]
    part = float((w.data[lo:hi].double() * x[
        s * KS.WINDOW + w.indices[lo:hi].long()].double()).sum())
    return (r, f"window {s}'s partial", hi - lo,
            abs(float(got[r]) - part - float(want[r])), float(tol[r]))
  s, e = int(packed.indptr[r]), int(packed.indptr[r + 1])
  j = s // KS.CHUNK + 1
  if j * KS.CHUNK >= e:
    j = packed.chunk_row.shape[0] // 2
    r = int(packed.chunk_row[j])
    e = int(packed.indptr[r + 1])
  lo, hi = j * KS.CHUNK, min(e, (j + 1) * KS.CHUNK)
  head = float((packed.data[lo:hi].double()
                * x[packed.indices[lo:hi].long()].double()).sum())
  return (r, f"chunk {j}'s head", hi - lo,
          abs(float(got[r]) - head - float(want[r])), float(tol[r]))


def check_spmv_full(packed, x, label: str):
  """K3c on a full-size pack (in the form the pack holds) against its plain
  version and itself (bit for bit), and the check's power: the result
  without one window's partial (windowed) or one chunk's head
  (unwindowed) must fail it.  Returns max|kernel - plain| and the worst
  share of the per-row bound."""
  args = (packed.indptr, packed.indices, packed.data, packed.chunk_row, x,
          packed.windows)
  got, want = KS.spmv_chunked(*args), KS.spmv_chunked_plain(*args)
  again = KS.spmv_chunked(*args)
  diff = (got - want).abs()
  tol = row_tol(packed.indptr, packed.indices, packed.data, x, want)
  share = float((diff / tol.clamp_min(1e-30)).max())
  check(bool((diff <= tol).all()), f"K3c disagrees with its plain version "
        f"on {label}: worst share of the per-row bound {share:.4g}")
  check(bool(torch.equal(got, again)), f"K3c is not deterministic on {label}")
  row, part, dropped, bad_err, row_bound = drop_chunk_head(packed, x, got,
                                                          want, tol)
  print(f"  K3c on {label}: a result without {part} of row {row} "
        f"({dropped} products) is off by {bad_err:.4g} against the row's "
        f"bound {row_bound:.4g}")
  check(bad_err > row_bound, f"K3c's check on {label} passes a result "
        f"without {part}")
  return float(diff.max()), share


def phase_spmv_chunked(device, card: str, big, R):
  """K3c against its plain version on its edge cases in both forms (the
  windowed form each pack holds, and the unwindowed form over the same
  CSR), three x dtypes, bit for bit on repeat; then timed on the urand
  2^22 graph (unwindowed) and ML-20M's R.T (windowed) beside its plain
  version, the other form, K3b and cuSPARSE; returns the R.T row."""
  check_ptxas("spmv_chunked", "chunk_pass", "K3c")
  gen = torch.Generator(device=device).manual_seed(47)
  worst = 0.0
  for label, A in chunk_cases():
    packed = KS.pack_windowed_unique(A)
    check((packed.windows is not None) == (A.nnz > 0),
          f"K3c's pack of {label} is {packed!r}")
    forms = [("unwindowed", None)]
    if packed.windows is not None:
      forms.append((f"{packed.windows.count} window(s)", packed.windows))
    for form, windows in forms:
      for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = torch.randn(A.shape[1], generator=gen, device=device).to(dtype)
        args = (packed.indptr, packed.indices, packed.data, packed.chunk_row,
                x, windows)
        got, again = KS.spmv_chunked(*args), KS.spmv_chunked(*args)
        want = KS.spmv_chunked_plain(*args)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = row_tol(packed.indptr, packed.indices, packed.data, x, want)
        err = float(diff.max()) if diff.numel() else 0.0
        share = (float((diff / tol.clamp_min(1e-30)).max()) if diff.numel()
                 else 0.0)
        same = bool(torch.equal(got, again))
        worst = max(worst, err)
        if dtype == torch.float32 or share > 0.5:
          print(f"  K3c {label:26s} {A.shape[0]}x{A.shape[1]} nnz={A.nnz} "
                f"chunks={packed.chunk_row.shape[0]} {form} "
                f"{str(dtype)[6:]}: max|kernel-plain| {err:.3g}, worst share "
                f"of the per-row bound {share:.3g}; repeat bitwise equal: "
                f"{same}")
        check(got.dtype == dtype and got.shape == (A.shape[0],)
              and bool(torch.isfinite(got).all())
              and bool((diff <= tol).all()),
              f"K3c ({form}) disagrees with its plain version on {label} "
              f"{dtype}")
        check(same, f"K3c ({form}) is not deterministic on {label} {dtype}")
  print("  (bfloat16 and float16 lines are printed where a share passes 0.5)")

  timings = {}
  for label, A, form in (("urand 2^22", big, "unwindowed"),
                         ("ML-20M R.T", R.T, "windowed")):
    before = dict(KS.counts)
    with Timer() as t_pack:
      packed = KS.pack_windowed_unique(A)
      torch.cuda.synchronize()
    key = f"chunked_{form}_packs"
    check(KS.counts == dict(before, **{key: before[key] + 1})
          and (packed.windows is not None) == (form == "windowed"),
          f"the unique pack of {label} is {packed!r}, not {form} "
          f"({KS.counts} after {before})")
    n, m = packed.shape
    nnz, nchunks = packed.nnz, packed.chunk_row.shape[0]
    x = torch.randn(m, generator=gen, device=device)
    args = (packed.indptr, packed.indices, packed.data, packed.chunk_row, x)
    err, share = check_spmv_full(packed, x, label)
    worst = max(worst, err)
    lib = torch.sparse_csr_tensor(packed.indptr.int(), packed.indices,
                                  packed.data, size=(n, m),
                                  check_invariants=False)
    csr = (packed.indptr, packed.indices, packed.data)
    fns = {"plain": lambda: KS.spmv_chunked_plain(*args),
           "kernel": lambda: KS.spmv_chunked(*args, packed.windows),
           "K3b": lambda: KS.spmv_csr(*csr, x),
           "cuSPARSE": lambda: lib @ x}
    if packed.windows is not None:
      fns["unwindowed"] = lambda: KS.spmv_chunked(*args)
    t = time_in_turns(fns, 20)
    nbytes = nnz * 8 + (n + 1) * 8 + (m + n) * 4 + nchunks * 8
    bound_ms, bound_by = bound(nbytes, 2 * nnz)
    longest = int((packed.indptr[1:] - packed.indptr[:-1]).max())
    other = (f", the unwindowed form {t['unwindowed']:.4f} ms"
             if "unwindowed" in t else "")
    print(f"  K3c time on {label} (n={n}, m={m}, nnz={nnz}, longest row "
          f"{longest}, {nchunks} chunks; {packed!r} built in "
          f"{t_pack.elapsed:.2f} s): kernel {t['kernel']:.4f} ms "
          f"({nnz / t['kernel'] / 1e6:.2f} Gnnz/s, "
          f"{nbytes / t['kernel'] / 1e6:.1f} GB/s){other}, plain "
          f"{t['plain']:.4f} ms, K3b spmv_csr {t['K3b']:.4f} ms, cuSPARSE "
          f"{t['cuSPARSE']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB); max|kernel-plain| {err:.3g}, "
          f"worst share of the per-row bound {share:.3g}, repeat bitwise "
          f"equal (median of {TIMING_REPS} x 20 calls queued ahead of the "
          f"device, CUDA events, in turns; queued ahead: "
          f"{all(t[f'{v} ahead'] for v in fns)}"
          f"; host issue per call: kernel {t['kernel host']:.4f} ms) on {card}")
    timings[label] = {"ms": t["kernel"], "plain_ms": t["plain"],
                      "library_ms": t["cuSPARSE"], "bound_ms": bound_ms,
                      "bound_by": bound_by}
    del packed, x, args, lib, csr, fns
  return dict(timings["ML-20M R.T"], max_abs_err=worst)


def phase_windowed_entry_point(device, big, R) -> int:
  """make_spmv_windowed over a classic and a unique pack of each matrix:
  each call moves its own kernel's count only, the two routes agree, and a
  float64 x raises.  Returns K3c's launches in this path."""
  gen = torch.Generator(device=device).manual_seed(53)
  for label, A, unique in (("urand 2^22", big, ("chunked_launches",)),
                           ("ML-20M R.T", R.T, ("chunked_launches",
                                                "chunked_windowed_launches"))):
    x = torch.randn(A.shape[1], generator=gen, device=device)
    ys = {}
    for kind, pack, keys in (("classic", KS.pack_windowed, ("csr_launches",)),
                             ("unique", KS.pack_windowed_unique, unique)):
      fn = KS.make_spmv_windowed(pack(A))
      before = dict(KS.counts)
      ys[kind] = fn(x)
      torch.cuda.synchronize()
      check(KS.counts == dict(before, **{k: before[k] + 1 for k in keys}),
            f"make_spmv_windowed on the {kind} pack of {label}: counts "
            f"{KS.counts} after {before}")
      try:
        fn(x.double())
        raised = False
      except NotImplementedError:
        raised = True
      check(raised, f"make_spmv_windowed({kind}) took a float64 x")
      del fn
    packed = KS.pack_windowed(A)
    tol = row_tol(packed.indptr, packed.indices, packed.data, x,
                  ys["classic"])
    diff = (ys["unique"] - ys["classic"]).abs()
    check(bool((diff <= tol).all()), f"the unique and classic routes "
          f"disagree on {label}")
    print(f"  make_spmv_windowed {label}: the classic pack launched K3b once, "
          f"the unique pack K3c once ({', '.join(unique)}); max|unique - "
          f"classic| "
          f"{float(diff.max()):.3g} (per-row bound); a float64 x raised "
          f"NotImplementedError on both")
    del packed, ys, x, diff, tol
  return KS.counts["chunked_launches"]


# -- k-means (config 4) and logistic regression (config 3) ---------------------

def numpy_lloyd(P, c, k: int, iters: int):
  """float64 Lloyd iterations from centers ``c``: labels by argmin of
  ||c||^2 - 2 p.c (ties to the first), centers by one-hot sums."""
  for _ in range(iters):
    labels = np.argmin((c * c).sum(1) - 2.0 * (P @ c.T), axis=1)
    onehot = (labels[:, None] == np.arange(k)[None, :]).astype(np.float64)
    c = (onehot.T @ P) / np.maximum(onehot.sum(0), 1.0)[:, None]
  return c, labels, onehot


def phase_kmeans_logreg(device, card: str):
  """kmeans.fit (one-hot matmul update), the shuffle scatter-add update and
  fit_fused at n = 2^19, d = k = 64 float32 against a float64 NumPy Lloyd
  from the same centers; logistic_reg.fit_fused at n = 2^20, d = 64
  float64 against a NumPy loop."""
  pts, true_c = kmeans.make_data(n=KM_N, d=KM_D, k=KM_K)
  P_host = pts.glom().astype(np.float32)
  del pts
  P = sp.from_numpy(P_host)
  # start next to the true centers: one center a blob, so the labels are
  # decided by wide margins
  c0 = true_c + 0.5 * np.random.default_rng(31).standard_normal(true_c.shape)
  P64 = P_host.astype(np.float64)
  with Timer() as t_np:
    c64, lab64, onehot = numpy_lloyd(P64, c0, KM_K, KM_ITERS)
  # a center is a sum of its m points' exact values over m: a float64 sum
  # in another order lies within 2 (m-1) 2^-53 sum|p| of the oracle's, a
  # float32 sum within (m-1) 2^-24 sum|p|; over m, plus one rounding of
  # the quotient (per center and coordinate)
  sum_abs = onehot.T @ np.abs(P64)
  tol64 = 2.0 ** -52 * (sum_abs + np.abs(c64))
  tol32 = 2.0 ** -24 * (sum_abs + np.abs(c64))
  del onehot
  results = {}
  torch.cuda.synchronize()
  with Timer() as t_fit:
    c_fit, lab_fit = kmeans.fit(P, KM_K, KM_ITERS, centers=sp.from_numpy(c0))
    results["fit (one-hot matmul)"] = (c_fit.glom(), lab_fit.glom(), tol64)
  with Timer() as t_scatter:
    c = sp.from_numpy(c0)
    for _ in range(KM_ITERS):
      lab = kmeans.assign_labels(P, c)
      c = sp.Val(kmeans.update_centers(P, lab, KM_K, use_matmul=False)
                 .evaluate())
    results["shuffle scatter-add"] = (c.glom(), lab.glom(), tol32)
  for label, (cg, lg, tol) in results.items():
    err = np.abs(cg - c64)
    print(f"  k-means {label}, n={KM_N} d={KM_D} k={KM_K} float32 points, "
          f"{KM_ITERS} iterations: labels equal to the float64 Lloyd's: "
          f"{bool(np.array_equal(lg, lab64))}; max|c - c64| {err.max():.3g}, "
          f"worst share of the bound {(err / tol).max():.3g}")
    check(cg.shape == (KM_K, KM_D) and bool(np.isfinite(cg).all()),
          f"k-means {label}: bad centers")
    check(np.array_equal(lg, lab64), f"k-means {label}: labels differ from "
          "the float64 Lloyd's")
    check(bool((err <= tol).all()), f"k-means {label}: centers outside the "
          "bound")
  again = kmeans.update_centers(P, lab, KM_K, use_matmul=False).glom()
  same = bool(np.array_equal(again, results["shuffle scatter-add"][0]))
  print(f"  shuffle scatter-add update repeated: bitwise equal {same}")
  check(same, "the shuffle scatter-add update changed on repeat")
  print(f"  k-means wall: fit {t_fit.elapsed:.3f} s, scatter loop "
        f"{t_scatter.elapsed:.3f} s (host clock, synced, first calls "
        f"included); NumPy float64 Lloyd {t_np.elapsed:.2f} s")

  run = sp.make_fori(
      lambda c_: kmeans.update_centers(P, kmeans.assign_labels(P, c_), KM_K),
      sp.from_numpy(c0))
  c_fori = run(KM_ITERS).glom()
  check(np.allclose(c_fori, results["fit (one-hot matmul)"][0], rtol=1e-12,
                    atol=0), "make_fori's k-means differs from fit")
  torch.cuda.synchronize()
  with Timer() as t_fori:
    run(KM_ITERS).data.sum().item()
  c_fused = kmeans.fit_fused(P, KM_K, KM_ITERS, centers=c0)
  check(isinstance(c_fused, sp.SpartanArray), "fit_fused did not return a "
        "SpartanArray")
  err = np.abs(c_fused.glom() - c64)
  check(c_fused.dtype == torch.float32 and bool((err <= tol32).all()),
        "fit_fused's centers are outside the float32 bound")
  torch.cuda.synchronize()
  with Timer() as t_fused:
    kmeans.fit_fused(P, KM_K, KM_ITERS, centers=c0).data.sum().item()
  print(f"  k-means steady ms/step (host clock, synced): make_fori(update "
        f"o assign) {t_fori.elapsed / KM_ITERS * 1e3:.3f} (equal to fit at "
        f"rtol 1e-12), fit_fused {t_fused.elapsed / KM_ITERS * 1e3:.3f} "
        f"(float32 throughout; max|c - c64| {err.max():.3g}, worst share of "
        f"the float32 bound {(err / tol32).max():.3g}) on {card}")
  del P, run

  X, y, _ = logistic_reg.make_data(n=LINREG_N, d=LINREG_D)
  X_host, y_host = X.glom(), y.glom()
  torch.cuda.synchronize()
  with Timer() as t_fit:
    w = logistic_reg.fit_fused(X, y, LOGREG_STEPS, LOGREG_ALPHA).glom()
  w_np = np.zeros(LINREG_D)
  for _ in range(LOGREG_STEPS):
    pred = 1.0 / (1.0 + np.exp(-(X_host @ w_np)))
    w_np = w_np - LOGREG_ALPHA * (X_host.T @ (pred - y_host) * (1.0 / LINREG_N))
  err = np.abs(w - w_np).max() / np.abs(w_np).max()
  acc = float((np.asarray(logistic_reg.predict(X, w).glom())
               == (y_host > 0.5)).mean())
  run = sp.make_fori(
      lambda w_: logistic_reg.gradient_step(X, y, w_, LOGREG_ALPHA),
      sp.zeros((LINREG_D,)))
  run(2).data.sum().item()
  torch.cuda.synchronize()
  with Timer() as t_steady:
    run(LOGREG_STEPS).data.sum().item()
  print(f"  logistic_reg.fit_fused n={LINREG_N} d={LINREG_D} float64, "
        f"{LOGREG_STEPS} steps: max rel err vs NumPy {err:.3g} (rtol 1e-10); "
        f"training accuracy {acc:.4f}; {t_fit.elapsed:.3f} s with the first "
        f"step's set-up, steady {t_steady.elapsed / LOGREG_STEPS * 1e3:.3f} "
        f"ms/step (host clock, synced) on {card}")
  check(w.shape == (LINREG_D,) and w.dtype == np.float64 and err <= 1e-10,
        "logistic regression disagrees with the NumPy loop")


# -- the sharded kernels on a mesh of p shards of the card ----------------------

SHARD_COUNTS = (2, 4, 8)
ADD_SWEEPS = 20  # the sharded Jacobi call with its add field
SHARDED = ("sharded_onehot_spmv", "sharded_windowed_spmv",
           "sharded_windowed_spmm", "stencil3x3_padded_sharded")


def nonempty(packed) -> int:
  return sum(packed.rows(d)[1] > packed.rows(d)[0]
             for d in range(packed.n_shards))


def sharded_path(p, mesh, graphs, S, u0, f):
  """The main path on a mesh of p shards, with every count at 0 just before
  and read just after: PageRank on both urand graphs, ALS, 200 heat sweeps
  and one Jacobi call with its add field through the sharded stencil.
  Returns the results and each sharded kernel's launches."""
  big_S, _ = graphs["urand 2^22"]
  small_S, _ = graphs["urand 32768"]
  torch.cuda.synchronize()
  for counts in (KS, K5, K6):
    counts.reset_counts()
  with Timer() as t_path:
    out = {"r_big": pagerank.fit_sparse(big_S, PR_ITERS, DAMPING),
           "r_small": pagerank.fit_sparse(small_S, PR_ITERS, DAMPING)}
    out["U"], out["V"] = als.fit(S, k=ALS_K, iterations=ALS_ITERS,
                                 reg=ALS_REG, seed=0)
    out["heat"] = K6.stencil3x3_padded_sharded(u0, HEAT, SWEEPS, mesh)
    out["jacobi"] = K6.stencil3x3_padded_sharded(
        torch.zeros_like(f), JACOBI, ADD_SWEEPS, mesh, add=-0.25 * f)
    torch.cuda.synchronize()
  launches = {"sharded_onehot_spmv": KS.counts["sharded_ell_launches"],
              "sharded_windowed_spmv": KS.counts["sharded_csr_launches"],
              "sharded_windowed_spmm": K5.counts["sharded_launches"],
              "stencil3x3_padded_sharded": K6.counts["k6b_launches"]}
  bands = len(KS.ell_bands(small_S.shape[0], p))
  csr_bands = nonempty(big_S.to_windowed_sharded(p))
  want = {"sharded_onehot_spmv": -(-bands // KS.MAX_BANDS) * PR_ITERS,
          "sharded_windowed_spmv": -(-csr_bands // KS.MAX_BANDS) * PR_ITERS,
          "sharded_windowed_spmm": ALS_ITERS * (
              nonempty(S.to_windowed_spmm_sharded(p))
              + nonempty(S.T.to_windowed_spmm_sharded(p))),
          "stencil3x3_padded_sharded": p * (SWEEPS + ADD_SWEEPS)}
  others = {**{k: v for k, v in KS.counts.items()
               if not k.startswith("sharded_") or "plain" in k},
            "K5 launches": K5.counts["launches"],
            "K5 plain_runs": K5.counts["plain_runs"],
            "K5 sharded_plain_runs": K5.counts["sharded_plain_runs"],
            **{k: v for k, v in K6.counts.items() if k != "k6b_launches"}}
  print(f"  p = {p}: path wall {t_path.elapsed:.2f} s; launches {launches} "
        f"(a shard: " + ", ".join(f"{k} {v / p:g}" for k, v in
                                  launches.items())
        + f"); other kernels and plain runs {others}")
  print(f"  p = {p}: K3a sharded launched "
        f"{launches['sharded_onehot_spmv'] / PR_ITERS:g} times a call over "
        f"{KS.counts['sharded_ell_bands'] / PR_ITERS:g} bands a call; K3d "
        f"{launches['sharded_windowed_spmv'] / PR_ITERS:g} times a call over "
        f"{KS.counts['sharded_csr_bands'] / PR_ITERS:g} bands a call")
  check(launches == want, f"p = {p}: sharded launches {launches}, expected "
        f"{want}")
  check(KS.counts["sharded_ell_bands"] == bands * PR_ITERS,
        f"p = {p}: K3a sharded covered {KS.counts['sharded_ell_bands']} bands "
        f"in {PR_ITERS} calls, expected {bands} a call")
  check(KS.counts["sharded_csr_bands"] == csr_bands * PR_ITERS,
        f"p = {p}: K3d covered {KS.counts['sharded_csr_bands']} bands in "
        f"{PR_ITERS} calls, expected {csr_bands} a call")
  check(not any(others.values()), f"p = {p}: an unsharded kernel or a plain "
        f"version ran on the sharded path ({others})")
  return out, launches


def check_sharded_results(p, out, graphs, als_ref, heat_t, f):
  """The path's results against phase 6's and phase 8's float64 oracles,
  phase 10's K6a field (bit for bit) and a float64 Jacobi oracle."""
  for key, label in (("r_big", "urand 2^22"), ("r_small", "urand 32768")):
    want = graphs[label][1]
    err = float(np.abs(out[key].astype(np.float64) - want).max())
    print(f"  p = {p}: PageRank {label}: max|r - r64| {err:.3g} (<= 1e-5 "
          f"max r64 = {1e-5 * want.max():.3g})")
    check(out[key].shape == want.shape and err <= 1e-5 * want.max(),
          f"p = {p}: sharded PageRank on {label} disagrees with scipy")
  U8, V8, U64, V64, tol = als_ref
  U, V = out["U"], out["V"]
  err_u = np.abs(U - U64).max() / np.abs(U64).max()
  err_v = np.abs(V - V64).max() / np.abs(V64).max()
  same = bool(np.array_equal(U, U8) and np.array_equal(V, V8))
  print(f"  p = {p}: ALS max rel err vs float64 scipy ALS U {err_u:.3g}, V "
        f"{err_v:.3g} (tolerance {tol:.3g}); factors bit-equal to phase "
        f"8's: {same}")
  check(bool(np.isfinite(U).all() and np.isfinite(V).all())
        and max(err_u, err_v) <= tol, f"p = {p}: sharded ALS disagrees")
  same_heat = bool(torch.equal(out["heat"], heat_t))
  print(f"  p = {p}: {SWEEPS} heat sweeps at {GRID_N}^2 float32 bit-equal "
        f"to phase 10's K6a result: {same_heat}")
  check(same_heat, f"p = {p}: the sharded heat sweeps differ from K6a's")
  u, scale = jacobi_oracle(f, ADD_SWEEPS)
  tol = 2 * 5 * 2.0 ** -24 * scale
  err = float((out["jacobi"].double() - u).abs().max())
  print(f"  p = {p}: {ADD_SWEEPS} Jacobi sweeps with the add field: max|u - "
        f"u64| {err:.4g} (tolerance {tol:.4g})")
  check(err <= tol, f"p = {p}: the sharded Jacobi sweeps disagree")
  del u


def held_to(p, name, got, want, tol):
  """|got - want| against the per-entry bound ``tol``; returns the worst
  |got - want| and its worst share of the bound."""
  diff = (got.double() - want.double()).abs()
  share = float((diff / tol.double().clamp_min(1e-300)).max())
  check(bool((diff <= tol.double()).all()), f"p = {p}: {name} disagrees with "
        f"its plain version: worst share of the bound {share:.4g}")
  return float(diff.max()), share


def bit_checks(p, mesh, graphs, S, device, gen):
  """One call of each sharded entry point against its unsharded kernel
  (bit for bit) and against its plain version on the same inputs, at the
  bound the unsharded kernel's full-size check uses (row_tol for the
  SpMVs, spmm_tolerance for the SpMM); returns the worst |kernel - plain|
  of each."""
  big_S, _ = graphs["urand 2^22"]
  small_S, _ = graphs["urand 32768"]
  worst, shares = {}, {}
  x = torch.randn(small_S.shape[1], generator=gen, device=device)
  cols, vals = small_S.cols, small_S.vals
  got = KS.sharded_onehot_spmv(cols, vals, x, mesh)
  check(torch.equal(got, KS.spmv_ell(cols, vals, x)),
        f"p = {p}: sharded_onehot_spmv differs from K3a")
  want = KS.spmv_ell_plain(cols, vals, x)
  worst["sharded_onehot_spmv"], shares["sharded_onehot_spmv"] = held_to(
      p, "sharded_onehot_spmv", got, want,
      row_tol(*small_S.to_csr(), x, want))
  x = torch.randn(big_S.shape[1], generator=gen, device=device)
  got = KS.sharded_windowed_spmv_traced(big_S.to_windowed_sharded(p), x,
                                        mesh)
  check(torch.equal(got, KS.spmv_csr(*big_S.to_csr(), x)),
        f"p = {p}: sharded_windowed_spmv_traced differs from K3b")
  want = KS.spmv_csr_plain(*big_S.to_csr(), x)
  worst["sharded_windowed_spmv"], shares["sharded_windowed_spmv"] = held_to(
      p, "sharded_windowed_spmv_traced", got, want,
      row_tol(*big_S.to_csr(), x, want))
  worst["sharded_windowed_spmm"] = shares["sharded_windowed_spmm"] = 0.0
  for label, A, m in (("R @ V", S, ML_MOVIES), ("R.T @ U", S.T, ML_USERS)):
    B = torch.randn(m, ALS_K, generator=gen, device=device)
    got = K5.sharded_windowed_spmm_traced(A.to_windowed_spmm_sharded(p), B,
                                          mesh)
    check(torch.equal(got, K5.spmm_csr(*A.to_csr(), B)),
          f"p = {p}: sharded_windowed_spmm_traced differs from K5a on "
          f"{label}")
    err, share = held_to(p, f"sharded_windowed_spmm_traced on {label}", got,
                         K5.spmm_csr_plain(*A.to_csr(), B),
                         spmm_tolerance(*A.to_csr(), B))
    worst["sharded_windowed_spmm"] = max(worst["sharded_windowed_spmm"], err)
    shares["sharded_windowed_spmm"] = max(shares["sharded_windowed_spmm"],
                                          share)
    del got, B
  # the long rows of SKEW_ROWS, one in each band at p = 8
  skewed = sparse.from_scipy(skewed_csr())
  for k in (3, ALS_K, 512):
    B = torch.randn(SKEW_M, k, generator=gen, device=device)
    check(torch.equal(
        K5.sharded_windowed_spmm_traced(skewed.to_windowed_spmm_sharded(p), B,
                                        mesh),
        K5.spmm_csr(*skewed.to_csr(), B)),
        f"p = {p}: sharded_windowed_spmm_traced differs from K5a on the "
        f"skewed matrix at k = {k}")
  del skewed, B
  torch.cuda.synchronize()
  print(f"  p = {p}: one call of each sharded SpMV/SpMM entry point "
        f"bit-equal to its unsharded kernel (the SpMM also on the skewed "
        f"matrix at k = 3, {ALS_K}, 512); max|kernel - plain| {worst}, "
        f"worst share of the per-entry bound {shares}")
  return worst


def time_sharded(p, mesh, graphs, S, device, gen, card):
  """Each sharded kernel at the main path's full shape, in turns beside
  the unsharded kernel, the plain version and one library call over the
  whole operand.  The bound counts each input read once and the output
  written once, as the unsharded kernels' bounds do; beside it is printed
  the bound with x (or B, or the halo rows) read once a shard."""
  big_S, _ = graphs["urand 2^22"]
  small_S, _ = graphs["urand 32768"]
  rows = {}

  def report(name, label, t, nbytes, flops, lib, replica_bytes, extra=None):
    bound_ms, bound_by = bound(nbytes, flops)
    replica_ms = bound(nbytes + replica_bytes, flops)[0]
    print(f"  p = {p}: {name} on {label}: kernel {t['kernel']:.4f} ms, "
          f"unsharded {t['unsharded']:.4f} ms ("
          f"{t['kernel'] / t['unsharded']:.3f}x), plain {t['plain']:.4f} ms, "
          f"{lib} {t['library']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes / 1e6:.1f} MB, each input read once; "
          f"{replica_ms:.4f} ms with the operand each shard reads again, "
          f"+{replica_bytes / 1e6:.2f} MB) (median of {TIMING_REPS}, "
          f"queued ahead: "
          f"{all(t[f'{v} ahead'] for v in ('kernel', 'unsharded', 'plain', 'library'))}"
          f", CUDA events, in turns; host issue per call: kernel "
          f"{t['kernel host']:.4f} ms) on {card}")
    rows[name] = dict({"ms": t["kernel"], "plain_ms": t["plain"],
                       "library_ms": t["library"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "unsharded_ms": t["unsharded"]},
                      **(extra or {}))

  # K3a sharded at n = 32768
  n, m = small_S.shape
  cols, vals = small_S.cols, small_S.vals
  x = torch.randn(m, generator=gen, device=device)
  indptr, indices, data = small_S.to_csr()
  lib = torch.sparse_csr_tensor(indptr.int(), indices, data, size=(n, m),
                                check_invariants=False)
  t = time_in_turns({
      "plain": lambda: KS.spmv_ell_plain(cols, vals, x),
      "kernel": lambda: KS.sharded_onehot_spmv(cols, vals, x, mesh),
      "unsharded": lambda: KS.spmv_ell(cols, vals, x),
      # about 256 launches a sample: more fill the launch queue, and the
      # host then waits on the device
      "library": lambda: lib @ x}, 256 // p)
  k = small_S.max_nnz_per_row
  report("sharded_onehot_spmv", f"urand 32768 (k={k})", t,
         n * k * 8 + m * 4 + n * 4, 2 * n * k, "cuSPARSE", (p - 1) * m * 4)
  # K3d on urand 2^22
  n, m = big_S.shape
  packed = big_S.to_windowed_sharded(p)
  indptr, indices, data = big_S.to_csr()
  x = torch.randn(m, generator=gen, device=device)
  lib = torch.sparse_csr_tensor(indptr.int(), indices, data, size=(n, m),
                                check_invariants=False)
  t = time_in_turns({
      "plain": lambda: KS.spmv_csr_plain(indptr, indices, data, x),
      "kernel": lambda: KS.sharded_windowed_spmv_traced(packed, x, mesh),
      "unsharded": lambda: KS.spmv_csr(indptr, indices, data, x),
      "library": lambda: lib @ x}, 20)
  report("sharded_windowed_spmv", f"urand 2^22 (nnz={big_S.nnz})", t,
         big_S.nnz * 8 + (n + p) * 8 + m * 4 + n * 4, 2 * big_S.nnz,
         "cuSPARSE", (p - 1) * m * 4)
  # K5b: ALS's two products, summed
  total = {key: 0.0 for key in ("kernel", "unsharded", "plain", "library")}
  total.update({f"{key} {what}": (0.0 if what == "host" else True)
                for key in list(total) for what in ("host", "ahead")})
  nbytes = flops = replicas = 0
  for A, m in ((S, ML_MOVIES), (S.T, ML_USERS)):
    packed = A.to_windowed_spmm_sharded(p)
    csr = A.to_csr()
    B = torch.randn(m, ALS_K, generator=gen, device=device)
    lib = torch.sparse_csr_tensor(csr[0].int(), csr[1], csr[2], size=A.shape,
                                  check_invariants=False)
    t = time_in_turns({
        "plain": lambda: K5.spmm_csr_plain(*csr, B),
        "kernel": lambda: K5.sharded_windowed_spmm_traced(packed, B, mesh),
        "unsharded": lambda: K5.spmm_csr(*csr, B),
        "library": lambda: lib @ B}, 3)
    for key in ("kernel", "unsharded", "plain", "library"):
      total[key] += t[key]
      total[f"{key} host"] += t[f"{key} host"]
      total[f"{key} ahead"] = total[f"{key} ahead"] and t[f"{key} ahead"]
    nbytes += A.nnz * 8 + (A.shape[0] + p) * 8 + m * ALS_K * 4 + (
        A.shape[0] * ALS_K * 4)
    flops += 2 * A.nnz * ALS_K
    replicas += (p - 1) * m * ALS_K * 4
    del lib, B
  report("sharded_windowed_spmm", f"ML-20M R @ V + R.T @ U (k={ALS_K})",
         total, nbytes, flops, "cuSPARSE", replicas)
  # K6b: one sweep at 16384^2 float32 (the halo exchange and p launches)
  n = GRID_N
  u = torch.rand((n, n), generator=gen, device=device)
  bands, bufs, fields = K6._padded_bands(u, p, None)
  xp = K6.to_padded(u)
  buf = torch.zeros_like(xp)
  K6._sharded_sweep(bands, bufs, HEAT, fields)
  one, _ = K6.stencil3x3_padded(xp, buf, HEAT)
  plain, _ = K6.stencil3x3_padded_plain(xp, torch.zeros_like(xp), HEAT)
  sharded = torch.cat([K6.from_padded(b) for b in bands])
  check(torch.equal(sharded, K6.from_padded(one)),
        f"p = {p}: one sharded sweep differs from K6a's")
  err = float((sharded - K6.from_padded(plain)).abs().max())
  check(err == 0.0, f"p = {p}: one sharded sweep differs from its plain "
        f"version by {err:.4g} (float32 is bit for bit)")
  del one, plain, sharded
  w = torch.tensor(HEAT, device=device).view(1, 1, 3, 3)
  u4 = u[None, None]
  t = time_in_turns({
      "plain": lambda: K6.stencil3x3_padded_plain(xp, buf, HEAT),
      "kernel": lambda: K6._sharded_sweep(bands, bufs, HEAT, fields),
      "unsharded": lambda: K6.stencil3x3_padded(xp, buf, HEAT),
      "library": lambda: F.conv2d(u4, w, padding=1)})
  report("stencil3x3_padded_sharded", f"{n}^2 float32, one heat sweep", t,
         8 * n * n, 2 * 5 * n * n, "cuDNN conv2d",
         4 * n * (2 * (p - 1) + 2 * p), {"max_abs_err": err})
  del bands, bufs, xp, buf, u
  return rows


def phase_sharded(device, card: str, graphs, R, als_ref, heat_ref):
  """The sharded kernels K3a sharded, K3d, K5b and K6b on meshes of 2, 4 and
  8 shards of the card: the main path through its entry points (PageRank,
  ALS, heat and Jacobi sweeps) against the earlier phases' oracles and
  results, each sharded entry point bit for bit against its unsharded
  kernel, then timed.  Returns each kernel's row (p = 8's times, launches
  summed over the three meshes)."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device=device).manual_seed(59)
  u0, heat_result = heat_ref
  heat_t = torch.from_numpy(heat_result).to(device)
  f = torch.randn((GRID_N, GRID_N), generator=gen, device=device)
  with Timer() as t_ingest:
    S = sparse.from_scipy(R, dtype=np.float32)
    S.T.to_csr()
    torch.cuda.synchronize()
  print(f"  the ratings again through sparse.from_scipy and the transpose: "
        f"{t_ingest.elapsed:.2f} s")
  launches = {name: 0 for name in SHARDED}
  worst = {name: 0.0 for name in SHARDED}
  rows = {}
  for p in SHARD_COUNTS:
    mesh = sp.make_mesh(device, shape=(p,))
    with sp.with_mesh(mesh):
      out, path = sharded_path(p, mesh, graphs, S, u0, f)
      check_sharded_results(p, out, graphs, als_ref, heat_t, f)
      del out
      for name in SHARDED:
        launches[name] += path[name]
      for name, err in bit_checks(p, mesh, graphs, S, device, gen).items():
        worst[name] = max(worst[name], err)
      rows = time_sharded(p, mesh, graphs, S, device, gen, card)
      worst["stencil3x3_padded_sharded"] = max(
          worst["stencil3x3_padded_sharded"],
          rows["stencil3x3_padded_sharded"].pop("max_abs_err"))
      try:
        K6.stencil3x3_padded_sharded(u0[:GRID_N - 1], HEAT, 1, mesh)
        raised = False
      except ValueError:
        raised = True
      check(raised, f"p = {p}: a ragged band did not raise")
  del S, heat_t, f
  print(f"  a field of {GRID_N - 1} rows raised ValueError at every p; "
        f"peak device memory in phase 14 "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
  for name in SHARDED:
    rows[name].update(launches=launches[name], max_abs_err=worst[name])
  return rows



# the expression surface at config 1's published 16384^2 float32
SURFACE_N, GATHER_ROWS, GATHER_PAIRS, AT_PAIRS = 16384, 4096, 1 << 22, 1 << 20
PROD_ROWS, NAN_COUNT = 64, 1000


def surface_check(label, got, want, rtol, why, secs):
  """Holds a result (evaluated on the card, fetched) against its float64
  NumPy oracle and prints both with the wall time."""
  got = np.asarray(got)
  want = np.asarray(want)
  check(got.shape == want.shape, f"{label}: shape {got.shape}, expected "
        f"{want.shape}")
  if rtol == 0:
    ok = bool(np.array_equal(got, want))
    err = 0.0 if ok else float(np.abs(got.astype(np.float64) - want).max())
  else:
    err = float(np.abs(got.astype(np.float64) - want).max()
                / max(float(np.abs(want).max()), 1e-300))
    ok = bool(np.isfinite(got).all()) and err <= rtol
  print(f"  {label}: max err {err:.3g} of max|oracle| (tolerance "
        f"{rtol:g}: {why}), wall {secs * 1e3:.1f} ms")
  check(ok, f"{label} disagrees with its NumPy oracle")


def phase_expression_surface(device, card: str) -> int:
  """The core expression surface through the entry points at 16384^2
  float32: K1's new instructions, the new reductions, slices, gathers, a
  boolean mask on the device, .at with duplicates and a NaN reduction,
  each against a float64 NumPy oracle on the host copy.  Returns K1's
  launches."""
  from spartan_tpu_torch.expr import slice as slice_mod
  rng = np.random.default_rng(15)
  host = rng.uniform(-1.0, 3.0, (SURFACE_N, SURFACE_N)).astype(np.float32)
  b = sp.from_numpy(host)
  h64 = host.astype(np.float64)
  K.reset_counts()
  elems = {"(b ** 2).sum()": (lambda: (b ** 2).sum(), host * host),
           "(b // 0.3).sum()": (lambda: (b // 0.3).sum(),
                                host // np.float32(0.3)),
           "(b % 0.7).sum()": (lambda: (b % 0.7).sum(),
                               host % np.float32(0.7))}
  for label, (fn, values) in elems.items():
    before = dict(K.counts)
    with Timer() as t:
      got = float(fn().glom())
    check(K.counts["launches"] == before["launches"] + 1
          and K.counts["routed_plain"] == before["routed_plain"],
          f"{label} did not launch K1 once ({K.counts} after {before})")
    # the chain computes in float32, as NumPy's float32 ufunc does; the sum
    # in float64 in another order
    surface_check(label, got, values.astype(np.float64).sum(), 1e-9,
                  "float64 sums in another order", t.elapsed)
  k1_launches = K.counts["launches"]
  del values
  with Timer() as t:
    got = float(sp.var(b).glom())
  surface_check("sp.var(b)", got, h64.var(), 1e-9,
                "float64 accumulation of float32 values", t.elapsed)
  with Timer() as t:
    got = float(sp.std(b, ddof=1).glom())
  surface_check("sp.std(b, ddof=1)", got, h64.std(ddof=1), 1e-9,
                "float64 accumulation of float32 values", t.elapsed)
  with Timer() as t:
    got = b[:PROD_ROWS].prod(axis=0).glom()
  surface_check(f"b[:{PROD_ROWS}].prod(axis=0)", got,
                h64[:PROD_ROWS].prod(axis=0), 1e-9,
                f"{PROD_ROWS} float64 products in another order", t.elapsed)
  with Timer() as t:
    got = (bool(sp.all(b > -1.5).glom()), bool(sp.any(b > 2.9999).glom()))
  surface_check("sp.all(b > -1.5), sp.any(b > 2.9999)", got,
                (bool((host > -1.5).all()), bool((host > 2.9999).any())), 0,
                "exact", t.elapsed)
  with Timer() as t:
    got = float(b[1:-1, 1:-1].sum().glom())
  surface_check("b[1:-1, 1:-1].sum()", got, h64[1:-1, 1:-1].sum(), 1e-9,
                "float64 sums in another order", t.elapsed)
  with Timer() as t:
    got = float(b[::2].mean().glom())
  surface_check("b[::2].mean()", got, h64[::2].mean(), 1e-9,
                "float64 sums in another order", t.elapsed)
  rows = rng.integers(0, SURFACE_N, GATHER_ROWS)
  with Timer() as t:
    got = b[rows].glom()
  surface_check(f"b[rows] ({GATHER_ROWS} rows, "
                f"{GATHER_ROWS * SURFACE_N * 4 / 1e6:.0f} MB)", got,
                host[rows], 0, "a gather copies", t.elapsed)
  del got
  r2 = rng.integers(0, SURFACE_N, GATHER_PAIRS)
  c2 = rng.integers(0, SURFACE_N, GATHER_PAIRS)
  with Timer() as t:
    got = b[sp.from_numpy(r2), sp.from_numpy(c2)].glom()
  surface_check(f"b[rows, cols] ({GATHER_PAIRS} elements)", got,
                host[r2, c2], 0, "a gather copies", t.elapsed)
  before = slice_mod.counts["boolean_mask_device"]
  with Timer() as t:
    got = b[b > 2.5].glom()
  check(slice_mod.counts["boolean_mask_device"] == before + 1,
        "b[b > 2.5] did not take the device boolean path")
  surface_check(f"b[b > 2.5] ({got.size} elements, on the device)", got,
                host[host > 2.5], 0, "a selection copies", t.elapsed)
  del got
  # .at with duplicates: a quarter of the pairs again
  ar = rng.integers(0, SURFACE_N, AT_PAIRS)
  ac = rng.integers(0, SURFACE_N, AT_PAIRS)
  ar = np.concatenate([ar, ar[:AT_PAIRS // 4]])
  ac = np.concatenate([ac, ac[:AT_PAIRS // 4]])
  with Timer() as t:
    got = b.at[sp.from_numpy(ar), sp.from_numpy(ac)].add(1.0).glom()
  want = h64.copy()
  np.add.at(want, (ar, ac), 1.0)
  # atomics: each updated value is a float32 sum of at most a few terms in
  # an order that varies from run to run: within 4 float32 ulps of the
  # largest |value| of the float64 product
  surface_check(f"b.at[rows, cols].add(1.0) ({ar.size} updates, "
                f"{AT_PAIRS // 4} duplicated)", got, want, 4 * 2.0 ** -24,
                "float32 atomics against np.add.at in float64", t.elapsed)
  del got, want
  nan_r = rng.integers(0, SURFACE_N, NAN_COUNT)
  nan_c = rng.integers(0, SURFACE_N, NAN_COUNT)
  with_nan = h64.copy()
  with_nan[nan_r, nan_c] = np.nan
  with Timer() as t:
    got = float(sp.nanmean(b.at[sp.from_numpy(nan_r), sp.from_numpy(nan_c)]
                           .set(float("nan"))).glom())
  surface_check(f"sp.nanmean(b with {NAN_COUNT} NaN planted)", got,
                np.nanmean(with_nan), 1e-9, "float64 sums in another order",
                t.elapsed)
  del with_nan, h64
  # the contiguous copy inside a sliced sum: K1 takes main.contiguous()
  inner = b.evaluate().data[1:-1, 1:-1]
  copy = inner.contiguous()
  ident = K.plan(None, 0, torch.float32, {})
  t = time_in_turns({
      "sliced sum": lambda: b[1:-1, 1:-1].sum().evaluate(),
      "copy": lambda: inner.contiguous(),
      "K1 on the copy": lambda: K.fused_sum(copy, ident, [], torch.float64),
      "K1 on b": lambda: K.fused_sum(b.evaluate().data, ident, [],
                                     torch.float64)})
  print(f"  b[1:-1, 1:-1].sum() at {SURFACE_N}^2 float32: "
        f"{t['sliced sum']:.4f} ms on the device, of which the contiguous "
        f"copy {t['copy']:.4f} ms ({100 * t['copy'] / t['sliced sum']:.1f} "
        f"%) and K1 on the copy {t['K1 on the copy']:.4f} ms; K1 on the "
        f"whole b {t['K1 on b']:.4f} ms (median of {TIMING_REPS}, CUDA "
        f"events, in turns) on {card}")
  del inner, copy, b
  torch.cuda.empty_cache()
  return k1_launches


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
  t_start = time.perf_counter()
  t_phase = [t_start]

  def done(phase: int) -> None:
    now = time.perf_counter()
    print(f"  phase {phase} wall {now - t_phase[0]:.2f} s")
    t_phase[0] = now

  print("phase 1: build the kernels, one nvcc per source, in parallel")
  build.load_all(KERNELS)
  for name in KERNELS:
    print(f"  built {build.library_path(name).name} in "
          f"{build.build_seconds.get(name, 0.0):.2f} s")
    for line in build.build_log(name).splitlines():
      if "registers" in line or "spill" in line:
        print("  ptxas:", line.strip())
  done(1)

  print("phase 2: K1 against its plain version on the card")
  k1 = phase_kernel_vs_plain(device, card)
  done(2)

  rng = np.random.default_rng(0)
  K.reset_counts()  # count the main path's launches only
  print("phase 3: fused map+reduce and dot through the port's entry points")
  phase_map_reduce_and_dot(rng)
  done(3)
  print("phase 4: linear-regression training")
  phase_training(rng)
  k1["launches"] = K.counts["launches"]
  check(k1["launches"] >= 1, "the main path never launched K1")
  done(4)

  big, small, cfg5 = (urand_graph(PR_BIG_N, 1), urand_graph(PR_SMALL_N, 2),
                      config5_graph())
  print("phase 5: K3a and K3b against their plain versions on the card")
  k3 = phase_spmv_kernels(device, card, big, small)
  done(5)

  KS.reset_counts()  # count the PageRank path's launches only
  print("phase 6: PageRank through pagerank.fit_sparse at full width")
  graphs = phase_pagerank(big, small, cfg5)  # held for phase 14
  k3["spmv_ell"]["launches"] = KS.counts["ell_launches"]
  k3["spmv_csr"]["launches"] = KS.counts["csr_launches"]
  done(6)

  print("phase 7: K5a against its plain version on the card; ratings of "
        "MovieLens 20M's shape")
  with Timer() as t_draw:
    R = movielens_shaped(device)
  print(f"  drew the ratings in {t_draw.elapsed:.2f} s")
  S = ingest_ratings(R)
  k5 = phase_spmm_kernel(device, card, S)
  done(7)

  K5.reset_counts()  # count the ALS path's launches only
  print("phase 8: ALS through als.fit at full width")
  k5["launches"], als_ref = phase_als(R, S)  # factors held for phase 14
  done(8)
  # the ratings' device arrays (ELL 25 GB, CSR, transposes) go with S; R
  # (host scipy) stays for phase 12.  Read what is left before and after a
  # collection of cyclic garbage, so that a cycle holding them shows.
  held = torch.cuda.memory_allocated()
  del S
  dropped = torch.cuda.memory_allocated()
  gc.collect()
  torch.cuda.empty_cache()
  print(f"  device memory allocated: {held / 1e9:.2f} GB with the ratings, "
        f"{dropped / 1e9:.2f} GB once they are dropped, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after gc.collect()")

  K6.reset_counts()  # K4's launches: phase 9's checks (no package caller)
  print("phase 9: K4 and K6a against their plain versions on the card")
  k4, k6a = phase_stencil_kernels(device, card)
  done(9)
  print("phase 10: heat and Jacobi-Poisson sweeps at 16384^2, heat.simulate, "
        "convnet")
  k6a["launches"], heat_ref = phase_stencil_path(device, card)
  done(10)

  print(f"  device memory allocated before phase 11: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
  print("phase 11: K2 against its plain version; matmul at 32768^2 float32 "
        "and 8192^2 bfloat16")
  worst_k2 = phase_matmul_kernel(device)
  K2.reset_counts()  # count the entry point's launches at full size only
  k2 = phase_matmul_path(device, card)
  k2_row = dict(k2[(CFG2_N, torch.float32)],
                max_abs_err=max(worst_k2, *(r["max_abs_err"]
                                            for r in k2.values())),
                launches=K2.counts["launches"])
  check(k2_row["launches"] >= 2 and K2.counts["plain_runs"] == 0,
        f"the matmul path did not launch K2 ({K2.counts})")
  done(11)

  print("phase 12: K3c against its plain version, timed on the urand 2^22 "
        "graph and ML-20M's R.T (held since phases 5 and 7); "
        "make_spmv_windowed on both packs")
  k3c = phase_spmv_chunked(device, card, big, R)
  KS.reset_counts()  # count the windowed entry point's launches only
  k3c["launches"] = phase_windowed_entry_point(device, big, R)
  check(k3c["launches"] >= 2 and KS.counts["chunked_windowed_launches"] >= 1
        and KS.counts["chunked_plain_runs"] == 0,
        f"make_spmv_windowed did not launch K3c in both forms ({KS.counts})")
  done(12)

  print("phase 13: k-means (config 4) and logistic regression (config 3)")
  phase_kmeans_logreg(device, card)
  done(13)

  print("phase 14: the sharded kernels on meshes of 2, 4 and 8 shards of the "
        "card: PageRank, ALS and stencil sweeps against phases 6, 8 and 10")
  sharded = phase_sharded(device, card, graphs, R, als_ref, heat_ref)
  del big, small, cfg5, R, graphs, als_ref, heat_ref
  done(14)
  gc.collect()
  torch.cuda.empty_cache()

  print("phase 15: the expression surface on the card at 16384^2 float32: "
        "**, //, % through K1, the new reductions, slices, gathers, a "
        "boolean mask, .at with duplicates, nanmean")
  surface_launches = phase_expression_surface(device, card)
  check(surface_launches >= 3, "phase 15 did not launch K1 three times")
  k1["launches"] += surface_launches
  done(15)
  print(f"  total wall {time.perf_counter() - t_start:.2f} s after phase 0")

  rows = [("fused_sum", "fused_reduce.cu",
           "spartan_tpu/backend/kernels/fused_reduce.py:65", k1),
          ("spmv_ell", "spmv_ell.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:106", k3["spmv_ell"]),
          ("spmv_csr", "spmv_csr.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:657", k3["spmv_csr"]),
          ("spmm_csr", "spmm_csr.cu",
           "spartan_tpu/backend/kernels/spmm_pallas.py:232", k5),
          ("stencil3x3", "stencil3x3.cu",
           "spartan_tpu/backend/kernels/stencil_pallas.py:73", k4),
          ("stencil3x3_padded", "stencil3x3_padded.cu",
           "spartan_tpu/backend/kernels/stencil_pallas.py:298", k6a),
          ("matmul", "matmul.cu",
           "spartan_tpu/backend/kernels/matmul.py:55", k2_row),
          ("spmv_chunked", "spmv_chunked.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:742", k3c),
          ("sharded_onehot_spmv", "spmv_ell.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:136",
           sharded["sharded_onehot_spmv"]),
          ("sharded_windowed_spmv", "spmv_csr.cu",
           "spartan_tpu/backend/kernels/spmv_pallas.py:888",
           sharded["sharded_windowed_spmv"]),
          ("sharded_windowed_spmm", "spmm_csr.cu",
           "spartan_tpu/backend/kernels/spmm_pallas.py:383",
           sharded["sharded_windowed_spmm"]),
          ("stencil3x3_padded_sharded", "stencil3x3_padded.cu",
           "spartan_tpu/backend/kernels/stencil_pallas.py:387",
           sharded["stencil3x3_padded_sharded"])]
  print(json.dumps({"kernels": [
      {"name": name, "route": "cuda",
       "source": f"spartan_tpu_torch/csrc/{source}", "replaces": replaces,
       **{key: row[key] for key in ("launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}
      for name, source, replaces, row in rows]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
