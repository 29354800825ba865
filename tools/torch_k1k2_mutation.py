"""Mutation check of K1's and K2's full-size result checks (card only).

    python3 tools/torch_k1k2_mutation.py

Builds, beside the kernels as they are, four mutants from copies of
``spartan_tpu_torch/csrc`` in a temporary directory: K2's 16-bit kernel
(``hopper_gemm`` in ``matmul.cu``) with the products of its middle K stage
skipped, K2's float32 kernel (``sgemm_tma``) with the products of its
middle K stage skipped, K1 (the op-program interpreter in
``op_program.cuh``) with the result of its second instruction dropped, and
K1's one-register rare variants (``fused_reduce_rare1.cu``) with CUDA's
``__sinf`` in place of the interpreter's sin.  Each runs through its wrapper at
chip_smoke.py's full size (8192^2 bfloat16 and 32768^2 float32 for K2,
``abs(1+2v)`` over 16384^2 float32 with a float64 sum for K1,
``sin(1e6 v)`` there against its float64 evaluation for the sin mutant)
and is held to chip_smoke.py's checks: the kernels as they are must pass,
the mutants must fail.  Prints each
check's worst share of its bound and exits non-zero if a check misses a
mutant.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import spartan_tpu_torch as sp  # noqa: E402
from spartan_tpu_torch.backend.kernels import build  # noqa: E402
from spartan_tpu_torch.backend.kernels import fused_reduce as K  # noqa: E402
from spartan_tpu_torch.backend.kernels import matmul as K2  # noqa: E402

# mutant -> (source it builds, file edited, text, its mutant)
MUTANTS = {
    "matmul bfloat16": (
        "matmul", "matmul.cu",
        "for (int kk = 0; kk < H_BK / 16; ++kk)",
        "for (int kk = 0; kk < (kb == nk / 2 ? 0 : H_BK / 16); ++kk)"),
    "matmul float32": (
        "matmul", "matmul.cu",
        "for (int kq = 0; kq < F_BK; kq += 4) {",
        "for (int kq = 0; kq < (kb == nk / 2 ? 0 : F_BK); kq += 4) {"),
    "fused_reduce": ("fused_reduce", "op_program.cuh",
                     "    f.set(dst, t);\n  }\n  f.get(prog.out, out);",
                     "    if (k != 1) f.set(dst, t);\n  }\n"
                     "  f.get(prog.out, out);"),
    "fused_reduce sin": (
        "fused_reduce_rare1", "op_program.cuh",
        "EACH1(sp_trig::trig(op - OP_SIN, p))",
        "EACH1(op == OP_SIN ? __sinf(p) : sp_trig::trig(op - OP_SIN, p))"),
}


def build_mutants(root: Path):
  """The mutant libraries, one nvcc per mutant, started together."""
  procs = {}
  for i, (name, (source, edited, text, mutant)) in enumerate(
      MUTANTS.items()):
    src = root / f"mutant{i}"
    shutil.copytree(build.CSRC, src)
    path = src / edited
    body = path.read_text()
    if body.count(text) != 1:
      raise RuntimeError(f"{edited}: the text to mutate is not there once")
    path.write_text(body.replace(text, mutant))
    so = src / f"lib{source}.so"
    procs[name] = (so, subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
         str(src / f"{source}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  libs = {}
  for name, (so, proc) in procs.items():
    log = proc.communicate()[0]
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed on the {name} mutant:\n{log}")
    libs[name] = ctypes.CDLL(str(so))
  return libs


def use(source: str, lib) -> None:
  """Route the wrapper of ``source`` to ``lib``: K2 binds it at its next
  launch, K1 reads ``build.load`` at every call."""
  build._libs[source] = lib
  build._bound.pop(source, None)


def k2_check(device, n: int, dtype: torch.dtype) -> str:
  gen = torch.Generator(device=device).manual_seed(43)
  x = torch.randn(n, n, generator=gen, device=device).to(dtype)
  y = torch.randn(n, n, generator=gen, device=device).to(dtype)
  got = K2.matmul(x, y)
  want = (torch.matmul(x, y) if dtype == torch.float32
          else K2.matmul_plain(x, y))
  try:
    err, share, tile, caught = cs.check_product(x, y, got, want,
                                                "the reference")
  except RuntimeError as e:
    return f"fails: {e}"
  return (f"passes: max|err| {err:.4g}, worst share of the bound "
          f"{share:.4g}")


def k1_check(device) -> str:
  gen = torch.Generator(device=device).manual_seed(1234)
  x = torch.randn(cs.TIMED_SHAPE, generator=gen, device=device)
  program = K.plan(cs.CHAINS["abs(1+2v)"][0], 0, torch.float32, {})
  got = K.fused_sum(x, program, [], torch.float64).item()
  want = K.fused_sum_plain(x, program, [], torch.float64).item()
  tol = cs.tolerance(False, torch.float64)
  share = cs.rel_err(got, want) / tol
  verdict = "passes" if share <= 1.0 else "fails"
  return (f"{verdict}: kernel {got:.17g}, plain {want:.17g}, share of the "
          f"rtol {tol:g}: {share:.4g}")


def k1_sin_check(device) -> str:
  """sin(1e6 v) over 16384^2 float32 against its float64 evaluation
  (chip_smoke.check_against_float64)."""
  gen = torch.Generator(device=device).manual_seed(1234)
  try:
    cs.check_against_float64(device, gen, ("sin(1e6v)",))
  except RuntimeError as e:
    return f"fails: {e}"
  return "passes: within an ulp an element of the float64 sum"


CHECKS = {
    "matmul bfloat16": lambda d: k2_check(d, cs.BENCH_MM_N, torch.bfloat16),
    "matmul float32": lambda d: k2_check(d, cs.CFG2_N, torch.float32),
    "fused_reduce": k1_check,
    "fused_reduce sin": k1_sin_check,
}


def main() -> int:
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return 1
  print(cs.card_line())
  sp.initialize(["--device=cuda"])
  torch.backends.cuda.matmul.allow_tf32 = False
  device = sp.get_mesh().device
  originals = build.load_all(["matmul", "fused_reduce", "fused_reduce_rare1"])
  with tempfile.TemporaryDirectory() as tmp:
    mutants = build_mutants(Path(tmp))
    results = {}
    for name, check in CHECKS.items():
      source, _, _, mutant = MUTANTS[name]
      for kind, lib in (("as it is", originals[source]),
                        ("mutant", mutants[name])):
        use(source, lib)
        results[name, kind] = check(device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"  {name} {kind}"
              f"{' (' + mutant + ')' if kind == 'mutant' else ''}: "
              f"{results[name, kind]}", flush=True)
      use(source, originals[source])
  ok = all(results[n, "as it is"].startswith("passes")
           and results[n, "mutant"].startswith("fails") for n in MUTANTS)
  print(f"mutation check: {'every mutant caught' if ok else 'MISSED'}")
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
