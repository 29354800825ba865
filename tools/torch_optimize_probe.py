"""chip_smoke.py's phase 23 alone on one NVIDIA GPU (about 70 s):

    python3 tools/torch_optimize_probe.py

Runs ``chip_smoke.phase_optimize_integrate``: sp.optimize's fits over 2^20
samples, minimizers, root finders and population methods, and
sp.integrate's solve_ivp of a 65,536-unknown heat equation and its rules
over 2^24 + 1 samples, each against its oracle (scipy's in two worker
processes).  No kernel is built: the phase launches none.  Prints the
card's name and power limit first.  A fresh process pays the first use of
CUDA, cuBLAS, cuSOLVER and torch.profiler inside the phase, which the
whole script's earlier phases pay there.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import spartan_tpu_torch as sp  # noqa: E402


def main() -> None:
  if not torch.cuda.is_available():
    raise RuntimeError("needs an NVIDIA GPU")
  card = cs.card_line()
  print(card)
  sp.initialize(["--device=cuda"])
  t0 = time.perf_counter()
  procs = cs.oracle_processes()
  try:
    oracles = cs.submit_phase23_oracles(procs)
    cs.phase_optimize_integrate(sp.get_mesh().device, card, oracles)
  finally:
    procs.shutdown()
  print(f"phase 23 alone {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
  main()
