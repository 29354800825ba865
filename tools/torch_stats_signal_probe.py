"""chip_smoke.py's phase 25 alone on one NVIDIA GPU (about two minutes):

    python3 tools/torch_stats_signal_probe.py

No kernel to build: sp.stats and sp.signal are torch code.  Starts the
phase's scipy oracles in two worker processes, then runs
``chip_smoke.phase_stats_signal`` (the distributions, descriptive
statistics, tests, gaussian_kde, the signal items, the recurrences and the
oscillator at full width).  Prints the card's name and power limit first,
and the accuracy of ``torch.special.ndtr`` in the left tail on the card
beside ``sp.special.ndtr``'s.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import spartan_tpu_torch as sp  # noqa: E402


def ndtr_tail(device) -> None:
  import scipy.special as ssp

  from spartan_tpu_torch.special import _ndtr
  z = np.concatenate([np.linspace(-37.0, -0.5, 4000),
                      np.linspace(0.5, 8.0, 100)])
  want = ssp.ndtr(z)
  t = torch.as_tensor(z, device=device)
  for label, fn in (("torch.special.ndtr", torch.special.ndtr),
                    ("sp.special.ndtr", _ndtr)):
    rel = np.abs(fn(t).cpu().numpy() / want - 1)
    print(f"  {label} on the card over z in [-37, 8]: largest relative "
          f"error {rel.max():.3g} (at z = {z[np.argmax(rel)]:.3f}), at "
          f"z = -6: {rel[np.argmin(np.abs(z + 6))]:.3g}")


def main() -> None:
  if not torch.cuda.is_available():
    raise RuntimeError("needs an NVIDIA GPU")
  card = cs.card_line()
  print(card)
  sp.initialize(["--device=cuda"])
  device = sp.get_mesh().device
  procs = cs.oracle_processes()
  oracles = cs.submit_phase25_oracles(procs)
  ndtr_tail(device)
  t0 = time.perf_counter()
  cs.phase_stats_signal(device, card, oracles)
  procs.shutdown()
  print(f"phase 25 alone: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
  main()
