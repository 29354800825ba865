"""chip_smoke.py's phase 24 alone on one NVIDIA GPU (a few minutes):

    python3 tools/torch_learn_probe.py [--only ITEM ...]

Builds the kernels the phase launches (K5a, K3a, K3b: spmm_csr.cu,
spmv_ell.cu, spmv_csr.cu, one nvcc each, in parallel), draws the ratings
of MovieLens 20M's shape and takes their svds(k=10) as phase 21 does (the
values learn.TruncatedSVD is held to), then runs
``chip_smoke.phase_learn_special``: learn's estimators at full width,
sp.special's device names at 2^24 points and the examples' CLI.  With
``--only``, only the named items run (``regression``, ``clustering``,
``knn``, ``naive_bayes``, ``netflix``, ``ratings``, ``black_scholes``,
``special``, ``cli``).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import spartan_tpu_torch as sp  # noqa: E402
from spartan_tpu_torch.backend.kernels import build  # noqa: E402


def main() -> None:
  parser = argparse.ArgumentParser()
  parser.add_argument("--only", nargs="*", default=None)
  only = parser.parse_args().only
  if not torch.cuda.is_available():
    raise RuntimeError("needs an NVIDIA GPU")
  card = cs.card_line()
  print(card)
  sp.initialize(["--device=cuda"])
  device = sp.get_mesh().device
  t0 = time.perf_counter()
  procs = cs.oracle_processes()
  try:
    oracles = cs.submit_phase24_oracles(procs)
    if only is None:
      build.load_all(("spmm_csr", "spmv_ell", "spmv_csr"))
      print(f"built in {time.perf_counter() - t0:.2f} s")
      R = cs.movielens_shaped(device)
      _, s21 = cs.svds_on_ratings(device, R, card)
      cs.phase_learn_special(device, card, oracles, procs, R, s21)
    else:
      pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)
      items = {
          "regression": lambda: cs.regression_items(device, card, oracles),
          "clustering": lambda: cs.clustering_items(device, card,
                                                    cs.gmm_start(procs)),
          "knn": lambda: cs.knn_item(card, oracles),
          "naive_bayes": lambda: cs.naive_bayes_item(device, pool),
          "netflix": lambda: cs.netflix_items(device, card),
          "black_scholes": lambda: cs.black_scholes_item(device, card, pool),
          "special": lambda: cs.special_items(device, card, pool),
          "cli": lambda: cs.cli_items(card, cs.cli_start())}
      for name in only:
        t = time.perf_counter()
        items[name]()
        print(f"  {name}: {time.perf_counter() - t:.2f} s")
      pool.shutdown()
  finally:
    procs.shutdown()
  print(f"phase 24 alone {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
  main()
