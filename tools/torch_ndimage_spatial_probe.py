"""chip_smoke.py's phase 26 alone on one NVIDIA GPU (about two minutes):

    python3 tools/torch_ndimage_spatial_probe.py

Builds K1 (``csrc/fused_reduce.cu``, which ``sp.ndimage.sum_labels`` of a
float32 image launches) while the phase's scipy oracles start in two
worker processes, then runs ``chip_smoke.phase_ndimage_spatial``: the
filters at 8192^2 float32, the morphology, label and measurements of
8192^2 blobs, the interpolation at 4096^2, cdist at 8192^2 x 64, a KDTree
of 2^18 points and Rotation over 2^20 quaternions.  Prints the card's name
and power limit first, and the phase's seconds with and without the wait
for its oracles.
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
from spartan_tpu_torch.backend.kernels import build  # noqa: E402


def main() -> None:
  if not torch.cuda.is_available():
    raise RuntimeError("needs an NVIDIA GPU")
  card = cs.card_line()
  print(card)
  sp.initialize(["--device=cuda"])
  device = sp.get_mesh().device
  procs = cs.oracle_processes()
  oracles = cs.submit_phase26_oracles(procs)
  t0 = time.perf_counter()
  build.load_all(("fused_reduce",))
  print(f"built fused_reduce.cu in {time.perf_counter() - t0:.2f} s")
  for future in oracles.values():
    future.result()
  print(f"the oracles ready {time.perf_counter() - t0:.2f} s after the build "
        "started")
  t0 = time.perf_counter()
  cs.phase_ndimage_spatial(device, card, oracles)
  procs.shutdown()
  print(f"phase 26 alone: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
  main()
