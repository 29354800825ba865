"""Sweep the segment size of the CSR SpMM kernel (K5a/K5b) on a CUDA card.

``spartan_tpu_torch/csrc/spmm_csr.cu`` cuts each row into segments of
``kSeg`` nonzeros (the wrapper's ``spmm.SEG``).  This script builds the
kernel at each of SEGS (one ``nvcc`` a size, all started together, into
``spartan_tpu_torch/_build/seg_sweep/``), then, at each size, on the
MovieLens-20M-shaped ratings of ``chip_smoke.py`` (phase 7) and ALS's two
products at k = 64:

  * checks K5a against its plain version (``chip_smoke.spmm_tolerance``)
    and K5b at p = 8 against K5a, bit for bit;
  * times K5a (both products), K5b at p = 8 and cuSPARSE in turns (CUDA
    events, median of chip_smoke's TIMING_REPS);
  * splits each kernel's device time into its two passes (segment_pass,
    combine_pass) with torch.profiler over one call.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_spmm_seg_sweep.py
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import spartan_tpu_torch as sp  # noqa: E402
from spartan_tpu_torch.backend import sparse  # noqa: E402
from spartan_tpu_torch.backend.kernels import build  # noqa: E402
from spartan_tpu_torch.backend.kernels import spmm as K5  # noqa: E402

SEGS = (128, 256, 512)
P = 8
LINE = f"constexpr int kSeg = {K5.SEG};"


def build_variants():
  """One library a segment size, built in parallel."""
  src = (build.CSRC / "spmm_csr.cu").read_text()
  if src.count(LINE) != 1:
    raise RuntimeError(f"spmm_csr.cu has no single line {LINE!r}")
  out = build.BUILD_DIR / "seg_sweep"
  out.mkdir(parents=True, exist_ok=True)
  nvcc = build.find_nvcc()
  procs = []
  for seg in SEGS:
    cu = out / f"spmm_csr_seg{seg}.cu"
    cu.write_text(src.replace(LINE, f"constexpr int kSeg = {seg};"))
    so = out / f"libspmm_csr_seg{seg}.so"
    procs.append((seg, so, subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(so), str(cu)],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)))
  libs = {}
  for seg, so, proc in procs:
    if proc.wait() != 0:
      raise RuntimeError(f"nvcc failed at kSeg = {seg}")
    libs[seg] = ctypes.CDLL(str(so))
  return libs


def use(seg, lib):
  """Route K5a/K5b's launches to ``lib`` at segment size ``seg``."""
  build._libs["spmm_csr"] = lib
  build._bound.pop("spmm_csr", None)
  K5.SEG = seg


def pass_ms(fn):
  """Device ms of one call of ``fn`` by pass: (segment_pass, combine_pass,
  everything else)."""
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  split = [0.0, 0.0, 0.0]
  for ev in prof.key_averages():
    if ev.device_type != DeviceType.CUDA:
      continue
    slot = (0 if "segment_pass" in ev.key
            else 1 if "combine_pass" in ev.key else 2)
    split[slot] += ev.self_device_time_total / 1e3
  return split


def main():
  if not torch.cuda.is_available():
    sys.exit("needs an NVIDIA GPU: torch.cuda.is_available() is False")
  sp.initialize()
  device = "cuda"
  card = cs.card_line()
  print(card, flush=True)
  libs = build_variants()
  S = sparse.from_scipy(cs.movielens_shaped(device), dtype=np.float32)
  gen = torch.Generator(device=device).manual_seed(3)
  prods = [(S, torch.randn(cs.ML_MOVIES, cs.ALS_K, generator=gen,
                           device=device)),
           (S.T, torch.randn(cs.ML_USERS, cs.ALS_K, generator=gen,
                             device=device))]
  csrs = [A.to_csr() for A, _ in prods]
  lib_csr = [torch.sparse_csr_tensor(c[0].int(), c[1], c[2], size=A.shape,
                                     check_invariants=False)
             for c, (A, _) in zip(csrs, prods)]
  mesh = sp.make_mesh(device, shape=(P,))
  for seg in SEGS:
    use(seg, libs[seg])
    packs = [K5.ShardedWindowedSpMM.pack(A, P) for A, _ in prods]

    def k5a():
      return [K5.spmm_csr(*c, B) for c, (_, B) in zip(csrs, prods)]

    def k5b():
      return [K5.sharded_windowed_spmm_traced(pk, B, mesh)
              for pk, (_, B) in zip(packs, prods)]

    def library():
      return [m @ B for m, (_, B) in zip(lib_csr, prods)]

    got = k5a()
    for y, c, (_, B) in zip(got, csrs, prods):
      diff = (y.double() - K5.spmm_csr_plain(*c, B).double()).abs()
      cs.check(bool((diff <= cs.spmm_tolerance(*c, B)).all()),
               f"kSeg = {seg}: K5a disagrees with its plain version")
    cs.check(all(torch.equal(a, b) for a, b in zip(got, k5b())),
             f"kSeg = {seg}: K5b at p = {P} differs from K5a")
    del got
    t = cs.time_in_turns({"K5a": k5a, "K5b": k5b, "cuSPARSE": library})
    a1, a2, a3 = pass_ms(k5a)
    b1, b2, b3 = pass_ms(k5b)
    print(f"kSeg {seg}: ALS's two products at k = {cs.ALS_K} on ML-20M's "
          f"shape: K5a {t['K5a']:.4f} ms (profiled: segment_pass {a1:.4f}, "
          f"combine_pass {a2:.4f}, table and casts {a3:.4f}), K5b at p = "
          f"{P} {t['K5b']:.4f} ms ({t['K5b'] / t['K5a']:.3f}x K5a; "
          f"profiled: segment_pass {b1:.4f}, combine_pass {b2:.4f}, other "
          f"{b3:.4f}), cuSPARSE {t['cuSPARSE']:.4f} ms; K5a bit-equal to "
          f"K5b, within spmm_tolerance of plain; on {card}", flush=True)
    del packs
  print("seg sweep ok")


if __name__ == "__main__":
  main()
