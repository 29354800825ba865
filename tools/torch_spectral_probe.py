"""chip_smoke.py's phase 21 alone on one NVIDIA GPU (about 3 min):

    python3 tools/torch_spectral_probe.py

First prints how orthonormal ``torch.linalg.eigh``'s float32 vectors of a
seeded symmetric 32 x 32 matrix (an eigsh restart's size) are on the card
(cuSOLVER) and on the host (LAPACK): the reason eigsh's fused restart
solves its small Ritz problem in float64.  Then builds the SpMV kernels K3a
(csrc/spmv_ell.cu) and K3b (csrc/spmv_csr.cu) and runs
``chip_smoke.phase_spectral``: eigsh, eigs, svds and
expm_multiply through K3a/K3b, LaplacianNd, sp.scipy_linalg at 4096^2
float64, the densified and host functions, with the phase's checks and
its host seconds by kind.  Prints the card's name and power limit first
and the launches the phase counted last.  A fresh process pays the first
use of cuBLAS, cuSOLVER and each elementwise kernel inside the phase,
which the whole script's earlier phases pay there.
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


def eigh_orthogonality(device) -> None:
  gen = torch.Generator(device).manual_seed(0)
  m = torch.randn(32, 32, generator=gen, device=device)
  h = (m + m.T) / 2
  for where, a in (("card (cuSOLVER)", h), ("host (LAPACK)", h.cpu())):
    w, y = torch.linalg.eigh(a)
    eye = torch.eye(32, device=a.device)
    print(f"float32 eigh of a 32 x 32 symmetric matrix on the {where}: "
          f"|Y^T Y - I| {float((y.T @ y - eye).abs().max()):.3g}, "
          f"|H Y - Y W| {float((a @ y - y * w).abs().max()):.3g}")


def main() -> None:
  if not torch.cuda.is_available():
    raise RuntimeError("torch.cuda.is_available() is False: this probe "
                       "needs an NVIDIA GPU")
  import scipy
  card = cs.card_line()
  print(card)
  print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, scipy "
        f"{scipy.__version__}")
  sp.initialize(["--device=cuda"])
  eigh_orthogonality(sp.get_mesh().device)
  build.load_all(("spmv_ell", "spmv_csr"))
  t0 = time.perf_counter()
  launches = cs.phase_spectral(sp.get_mesh().device, card)
  cs.print_host_spans(21, time.perf_counter() - t0)
  print(f"phase 21 launches: K3a {launches['ell']}, K3b {launches['csr']}")


if __name__ == "__main__":
  main()
