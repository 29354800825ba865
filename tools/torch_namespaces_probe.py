"""Where chip_smoke.py's phase 20 spends its time (one H100, about 5 min):

    python3 tools/torch_namespaces_probe.py [--numpy-unique]

1. ``sp.linalg.eigvalsh_lanczos(L, k=6)`` of the 5-point Laplacian built by
   ``sp.sparse.kronsum`` at 256^2 and 2048^2, three times each on the host
   clock (the first run in a fresh process pays the first use of cuBLAS
   and of each elementwise kernel), then once under ``torch.profiler``
   (device and host time by op);
2. ``sp.sparse.random`` at 2^22 x 2^22 with 2^26 entries under cProfile
   (its host seconds by function; NumPy's generator methods count in
   ``random``'s own time); with ``--numpy-unique``, also the
   reference's ``np.unique`` of its first draw beside the port's sorted
   ``torch.unique`` on the card (the same values);
3. ``sp.linalg``'s svd, slogdet, inv and eigh at 4096^2 float64 under
   ``torch.profiler``;
4. the rest of phase 20 (``dense_linalg_items``, ``fft_items``,
   ``draw_items``, ``file_items``) with its host seconds by kind.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import spartan_tpu_torch as sp  # noqa: E402
from spartan_tpu_torch.backend.kernels import build  # noqa: E402


def lanczos_times() -> None:
  from torch.profiler import ProfilerActivity, profile
  for side in (256, 2048):
    L = cs.kronsum_laplacian(side, side, np.float32)
    for rep in range(3):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      sp.linalg.eigvalsh_lanczos(L, k=cs.LANCZOS_K)
      torch.cuda.synchronize()
      print(f"lanczos at {side}^2, run {rep}: "
            f"{time.perf_counter() - t0:.3f} s")
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    sp.linalg.eigvalsh_lanczos(L, k=cs.LANCZOS_K)
    torch.cuda.synchronize()
  print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def random_profile() -> None:
  """``sp.sparse.random`` at phase 20's size under cProfile: the host
  seconds of its NumPy draws and torch calls, by function."""
  import cProfile
  import pstats
  density = cs.SPRAND_PER_ROW / cs.SPRAND_N
  prof = cProfile.Profile()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  prof.enable()
  S = sp.sparse.random(cs.SPRAND_N, cs.SPRAND_N, density=density,
                       random_state=20, dtype=np.float32)
  torch.cuda.synchronize()
  prof.disable()
  print(f"sp.sparse.random({cs.SPRAND_N}, {cs.SPRAND_N}, density="
        f"{density:.3g}): {time.perf_counter() - t0:.3f} s, nnz {S.nnz}")
  pstats.Stats(prof).sort_stats("tottime").print_stats(8)


def numpy_unique(device) -> None:
  """``--numpy-unique``: NumPy's ``np.unique`` (the reference's step) beside
  a sorted ``torch.unique`` on the card, over one draw of the size
  ``sp.sparse.random``'s first draw takes at phase 20's size (about 6 min
  on the host)."""
  nnz = cs.SPRAND_PER_ROW * cs.SPRAND_N
  keys = np.random.default_rng(20).integers(
      0, cs.SPRAND_N * cs.SPRAND_N, size=int(nnz * 1.3) + 16)
  t0 = time.perf_counter()
  host = np.unique(keys)
  t1 = time.perf_counter()
  flat = torch.unique(torch.from_numpy(keys).to(device))
  torch.cuda.synchronize()
  t2 = time.perf_counter()
  print(f"np.unique (NumPy {np.__version__}) of {keys.size} int64: "
        f"{t1 - t0:.3f} s; torch.unique on the card {t2 - t1:.3f} s; the "
        f"same values {np.array_equal(host, flat.cpu().numpy())}")


def factorizations() -> None:
  """``sp.linalg``'s svd, slogdet, inv and eigh of phase 20's 4096^2
  float64 matrices under ``torch.profiler``: device time by kernel, after
  one call of each outside it."""
  from torch.profiler import ProfilerActivity, profile
  gen = torch.Generator("cuda").manual_seed(200)
  n = cs.DENSE_N
  G = torch.randn(n, n, generator=gen, dtype=torch.float64, device="cuda")
  P = G @ G.T / n + torch.eye(n, dtype=torch.float64, device="cuda")
  items = {"svd": lambda: sp.evaluate(list(sp.linalg.svd(sp.Val(sp.SpartanArray(G))))),
           "slogdet": lambda: sp.evaluate(list(sp.linalg.slogdet(
               sp.Val(sp.SpartanArray(P))))),
           "inv": lambda: sp.linalg.inv(sp.Val(sp.SpartanArray(P))).evaluate(),
           "eigh": lambda: sp.evaluate(list(sp.linalg.eigh(
               sp.Val(sp.SpartanArray(P)))))}
  for name, fn in items.items():
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
    print(f"{name} at {n}^2 float64: wall {wall:.3f} s")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8))


def main() -> None:
  print(cs.card_line())
  sp.initialize(["--device=cuda"])
  device = sp.get_mesh().device
  build.load_all(("fused_reduce", "spmv_ell", "spmv_csr"))
  lanczos_times()
  random_profile()
  if "--numpy-unique" in sys.argv[1:]:
    numpy_unique(device)
  factorizations()
  torch.cuda.empty_cache()
  cs.HOST_SPANS.clear()
  t0 = time.perf_counter()
  card = cs.card_line()
  with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
    cs.dense_linalg_items(device, pool, card)
    cs.fft_items(device, pool, card)
  cs.draw_items(device)
  cs.file_items(device)
  cs.print_host_spans(20, time.perf_counter() - t0)
  print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB")


if __name__ == "__main__":
  main()
