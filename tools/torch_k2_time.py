"""Times K2 (``matmul.matmul``) beside cuBLAS on the card, for the package
under a given checkout, so that two versions can be held side by side in
one chip call (card only).

    python3 tools/torch_k2_time.py [ROOT] [--n 32768] [--dtype float32]
        [--reps 3]

ROOT (default: this checkout) is the directory that holds the
``spartan_tpu_torch`` to time; its kernels build into its own ``_build``.
Prints the card, the root, and the median over ``--reps`` of the kernel's
and cuBLAS's device time for one product of two n x n matrices (CUDA
events, the kernel and cuBLAS in turns, TF32 off).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("root", nargs="?",
                  default=str(Path(__file__).resolve().parents[1]))
  ap.add_argument("--n", type=int, default=32768)
  ap.add_argument("--dtype", default="float32")
  ap.add_argument("--reps", type=int, default=3)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return 1
  root = str(Path(args.root).resolve())
  sys.path.insert(0, root)
  import spartan_tpu_torch as sp
  from spartan_tpu_torch.backend.kernels import matmul as K2
  if not K2.__file__.startswith(root):
    raise RuntimeError(f"imported {K2.__file__}, not the package in {root}")
  sp.initialize(["--device=cuda"])
  torch.backends.cuda.matmul.allow_tf32 = False
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  gen = torch.Generator(device="cuda").manual_seed(43)
  dtype = getattr(torch, args.dtype)
  x = torch.randn(args.n, args.n, generator=gen, device="cuda").to(dtype)
  y = torch.randn(args.n, args.n, generator=gen, device="cuda").to(dtype)
  fns = {"kernel": lambda: K2.matmul(x, y), "cuBLAS": lambda: x @ y}
  times = {name: [] for name in fns}
  for fn in fns.values():
    fn()
  for _ in range(args.reps):
    for name, fn in fns.items():
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      torch.cuda.synchronize()
      start.record()
      fn()
      end.record()
      end.synchronize()
      times[name].append(start.elapsed_time(end))
  med = {name: statistics.median(v) for name, v in times.items()}
  print(f"{card}; root {root}; {args.n}^2 {args.dtype}: kernel "
        f"{med['kernel']:.4f} ms, cuBLAS {med['cuBLAS']:.4f} ms (median of "
        f"{args.reps}, CUDA events, in turns); samples {times}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
