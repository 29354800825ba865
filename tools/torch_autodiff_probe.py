"""chip_smoke.py's phase 22 alone on one NVIDIA GPU (about 4 min):

    python3 tools/torch_autodiff_probe.py [--remat-memory]

Builds K1's common source (csrc/fused_reduce.cu) and K3b (csrc/spmv_csr.cu),
times K1 on config 1's abs(1 + 2b) as phase 2 does, ingests phase 6's urand
2^22 graph with its float64 scipy PageRank, then runs
``chip_smoke.phase_autodiff_csgraph``: sp.compile through K1 and K3b, the
derivatives at config 3's shape and through SpMV and SpMM, sp.minimize,
convnet's training with remat, and sp.sparse.csgraph on the urand graph,
a cut grid and a 4096-vertex Floyd-Warshall, each against its oracle.
Prints the card's name and power limit first and the launches the phase
counted last.  ``--remat-memory`` instead prints the device memory of one
gradient step of convnet's loss at MNIST's test-set shape with and without
remat around the first block.  A fresh process pays the first use of cuBLAS, cuDNN and
each elementwise kernel inside the phase, which the whole script's
earlier phases pay there.
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
from spartan_tpu_torch.backend import sparse  # noqa: E402
from spartan_tpu_torch.backend.kernels import build  # noqa: E402
from spartan_tpu_torch.backend.kernels import fused_reduce as K  # noqa: E402


def remat_memory(device) -> None:
  """One value-and-gradient step of convnet's loss at MNIST's test-set
  shape with and without remat around the first block: the peak device
  memory above the start after the forward and after the backward, and
  the bytes autograd saved in the forward."""
  import numpy as np
  from spartan_tpu_torch import autodiff
  from spartan_tpu_torch.examples import convnet
  rng = np.random.default_rng(27)
  images = rng.standard_normal(cs.MNIST_SHAPE)
  onehot = np.eye(10)[rng.integers(0, 10, cs.MNIST_SHAPE[0])]
  params = convnet.init_params(n_classes=10)
  for remat in (False, True, False, True):
    leaves = {k: sp.lazify(v) for k, v in params.items()}
    loss = convnet.loss_expr(sp.lazify(images), onehot, leaves,
                             remat_first=remat)
    fn, args = autodiff.as_function(loss, list(leaves.values()),
                                    differentiable=True)
    ls = autodiff._leaves(args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    saved = {}

    def pack(t):
      saved[t.data_ptr()] = t.numel() * t.element_size()
      return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
      out = fn(*ls)
    torch.cuda.synchronize()
    fwd = (torch.cuda.max_memory_allocated() - base) / 1e9
    held = (torch.cuda.memory_allocated() - base) / 1e9
    torch.autograd.grad(out, ls)
    torch.cuda.synchronize()
    bwd = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"remat {remat}: forward peak {fwd:.3f} GB, held after it "
          f"{held:.3f} GB (saved {sum(saved.values()) / 1e9:.3f} GB), peak "
          f"through the backward {bwd:.3f} GB")
    del fn, args, ls, out


def main() -> None:
  if not torch.cuda.is_available():
    raise RuntimeError("torch.cuda.is_available() is False: this probe "
                       "needs an NVIDIA GPU")
  card = cs.card_line()
  print(card)
  sp.initialize(["--device=cuda"])
  device = sp.get_mesh().device
  build.load_all(("fused_reduce", "spmv_csr"))
  if "--remat-memory" in sys.argv:
    remat_memory(device)
    return
  gen = torch.Generator(device=device).manual_seed(0)
  x = torch.randn(cs.TIMED_SHAPE, generator=gen, device=device)
  program = K.plan(cs.CHAINS["abs(1+2v)"][0], 0, torch.float32, {})
  k1_ms = cs.time_in_turns({"k1": lambda: K.fused_sum(
      x, program, [], torch.float64)})["k1"]
  del x
  with cs.oracle_processes() as procs:
    oracles = cs.submit_phase22_oracles(procs)
    t0 = time.perf_counter()
    A = cs.urand_graph(cs.PR_BIG_N, 1)
    S = sparse.from_scipy(A)
    want = cs.scipy_pagerank(A)
    del A
    print(f"K1 abs(1+2v) at {cs.TIMED_SHAPE} float32 {k1_ms:.4f} ms; urand "
          f"2^22 and its float64 PageRank in {time.perf_counter() - t0:.2f} "
          "s (the phase's oracles run in two worker processes meanwhile)")
    t0 = time.perf_counter()
    launches = cs.phase_autodiff_csgraph(device, card, S, want, k1_ms,
                                         oracles)
  print(f"phase 22 alone: {time.perf_counter() - t0:.2f} s; launches "
        f"{launches}")


if __name__ == "__main__":
  main()
