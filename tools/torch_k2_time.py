"""Times K2 (``matmul.matmul``) beside cuBLAS on the card, for the package
under a given checkout, so that two versions can be held side by side in
one chip call (card only).

    python3 tools/torch_k2_time.py [ROOT] [--n 32768] [--dtype float32]
        [--reps 3]

ROOT (default: this checkout) is the directory that holds the
``spartan_tpu_torch`` to time; its kernels build into its own ``_build``.
Prints the card, the root, and the median over ``--reps`` of the device
time of one product of two n x n matrices for the kernel and for cuBLAS
(CUDA events, in turns, TF32 off), and the median SM clock and power draw
that ``nvidia-smi`` read while each ran (sampled every 100 ms).
"""

from __future__ import annotations

import argparse
import datetime
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def sampled(fn):
  """(device ms of ``fn``, the SM clock (MHz) and power draw (W) samples
  nvidia-smi read while it ran)."""
  smi = subprocess.Popen(
      ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
       "--format=csv,noheader,nounits", "-lms", "100"],
      stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
  time.sleep(0.5)  # nvidia-smi's start
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  torch.cuda.synchronize()
  t0 = datetime.datetime.now()
  start.record()
  fn()
  end.record()
  end.synchronize()
  t1 = datetime.datetime.now()
  smi.terminate()
  clocks, watts = [], []
  for line in smi.communicate()[0].splitlines():
    parts = [v.strip() for v in line.split(",")]
    try:
      when = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
      if t0 <= when <= t1:
        clocks.append(float(parts[1]))
        watts.append(float(parts[2]))
    except (ValueError, IndexError):
      continue
  return start.elapsed_time(end), clocks, watts


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
  clocks = {name: [] for name in fns}
  watts = {name: [] for name in fns}
  for rep in range(args.reps + 1):  # the first turn warms up
    for name, fn in fns.items():
      ms, mhz, w = sampled(fn)
      if rep:
        times[name].append(ms)
        clocks[name] += mhz
        watts[name] += w
  flops = 2.0 * args.n ** 3
  for name, samples in times.items():
    med = statistics.median(samples)
    clock = (f"SM clock {statistics.median(clocks[name]):.0f} MHz, power "
             f"{statistics.median(watts[name]):.0f} W (median of "
             f"{len(clocks[name])} samples)" if clocks[name]
             else "no clock sample")
    print(f"{card}; root {root}; {args.n}^2 {args.dtype}: {name} "
          f"{med:.4f} ms ({flops / med / 1e9:.1f} TFLOP/s), {clock} (median "
          f"of {args.reps}, CUDA events, in turns); samples {samples}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
