"""Times K1 (``fused_reduce.fused_sum``) on the card for the package under
a given checkout, so that two versions can be held side by side in one
chip call (card only).

    python3 tools/torch_k1_time.py [ROOT] [--n 16384] [--reps 7]

ROOT (default: this checkout) is the directory that holds the
``spartan_tpu_torch`` to time; its kernels build into its own ``_build``.
Prints the card, the root, ptxas's registers and stack frame of each
``fused_sum_partials`` kernel, and for each chain of ``CHAINS`` that the
root's op table holds the median device time over ``--reps`` of K1 on an
n x n float32 operand with a float64 accumulator, beside ``torch.sum``
(CUDA events, the calls queued behind a spin kernel, in turns).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SPIN_CYCLES = 20_000_000


def event_ms(fn, inner: int = 10) -> float:
  """Device ms per call of ``fn`` over ``inner`` calls queued behind a
  spin kernel that outlasts their issue."""
  marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
  marks[0].record()
  torch.cuda._sleep(SPIN_CYCLES)
  marks[1].record()
  for _ in range(inner):
    fn()
  marks[2].record()
  marks[2].synchronize()
  return marks[1].elapsed_time(marks[2]) / inner


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("root", nargs="?",
                  default=str(Path(__file__).resolve().parents[1]))
  ap.add_argument("--n", type=int, default=16384)
  ap.add_argument("--reps", type=int, default=7)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return 1
  root = str(Path(args.root).resolve())
  sys.path.insert(0, root)
  import spartan_tpu_torch as sp
  from spartan_tpu_torch.backend.kernels import build
  from spartan_tpu_torch.backend.kernels import fused_reduce as K
  from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
  from spartan_tpu_torch.expr.map import UFUNCS
  if not K.__file__.startswith(root):
    raise RuntimeError(f"imported {K.__file__}, not the package in {root}")
  sp.initialize(["--device=cuda"])
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()

  def call(name, *deps):
    return FnCallExpr(UFUNCS[name], list(deps))

  v = LocalInput(0)
  chains = {
      "identity": None,
      "abs(1+2v)": call("absolute", call("add", LocalConst(1.0), call(
          "multiply", v, LocalConst(2.0)))),
      "exp(-v*v)": call("exp", call("multiply", call("negative", v), v)),
      "abs(v)**2.5": ("power", lambda: call("power", call("absolute", v),
                                            LocalConst(2.5))),
      "v//0.3": ("floor_divide", lambda: call("floor_divide", v,
                                              LocalConst(0.3))),
      "v%0.7": ("remainder", lambda: call("remainder", v, LocalConst(0.7))),
  }
  x = torch.randn(args.n, args.n, generator=torch.Generator(
      device="cuda").manual_seed(7), device="cuda")
  fns = {}
  for name, chain in chains.items():
    if isinstance(chain, tuple):
      if chain[0] not in K.OPS:
        continue  # an op table without this op
      chain = chain[1]()
    program = K.plan(chain, 0, torch.float32, {})
    fns[name] = lambda p=program: K.fused_sum(x, p, [], torch.float64)
  fns["torch.sum"] = lambda: torch.sum(x, dtype=torch.float64)
  build.load("fused_reduce")
  for line in build.build_log("fused_reduce").splitlines():
    if "registers" in line or "stack frame" in line:
      print(f"  ptxas: {line.strip()}")
  for fn in fns.values():
    fn()
  samples = {name: [] for name in fns}
  for _ in range(args.reps):
    for name, fn in fns.items():
      samples[name].append(event_ms(fn))
  for name, got in samples.items():
    print(f"{card}; root {root}; K1 {args.n}^2 float32, float64 acc: "
          f"{name} {statistics.median(got):.4f} ms (median of {args.reps}, "
          f"CUDA events, in turns); samples "
          f"{[round(t, 4) for t in got]}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
