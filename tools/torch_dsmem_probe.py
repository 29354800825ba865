"""Rate of random 4-byte gathers on the card: from the L2, from a block's
own shared memory and from a thread-block cluster's distributed shared
memory (card only, about 1 min).

    python3 tools/torch_dsmem_probe.py [--iters 512] [--reps 5]

Builds ``csrc/dsmem_probe.cu`` through ``build.load`` and times, with CUDA
events, one launch of each mode (median of ``--reps``), 1024 threads a
block, each thread 8 independent streams of uniform random indices:

* L2: x of 2^22 floats (16.8 MB, urand 2^22's x) in device memory, two
  blocks an SM;
* shared: 49,152 floats (192 KB) of a block's shared memory, a block an SM;
* cluster: clusters of 2, 4, 8 and 16 blocks of 192 KB each, a gather
  landing in any block of its cluster (``ld.shared::cluster``), as many
  clusters as ``cudaOccupancyMaxActiveClusters`` says fit at once.

It prints each rate in gathers a second over the whole card, the active
clusters and the SMs they cover, and the rule that decides whether the
CSR SpMV gathers x from a cluster's shared memory: some cluster size
reaching RULE_RATE gathers a second with its active clusters covering at
least RULE_SMS SMs.  The last line is a JSON object of the same numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spartan_tpu_torch.backend.kernels import build  # noqa: E402

X_FLOATS = 1 << 22
WINDOW = 49152  # floats: 192 KB of shared memory a block
CLUSTERS = (2, 4, 8, 16)
RULE_RATE = 135e9
RULE_SMS = 120


def bind():
  lib = build.load("dsmem_probe")
  lib.spartan_dsmem_probe.argtypes = [
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
      ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
      ctypes.c_void_p]
  lib.spartan_dsmem_probe.restype = ctypes.c_int
  lib.spartan_dsmem_probe_clusters.argtypes = [
      ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
  lib.spartan_dsmem_probe_clusters.restype = ctypes.c_int
  lib.spartan_cuda_error_string.argtypes = [ctypes.c_int]
  lib.spartan_cuda_error_string.restype = ctypes.c_char_p
  return lib


def checked(lib, rc: int, what: str) -> None:
  if rc != 0:
    raise RuntimeError(f"{what}: {lib.spartan_cuda_error_string(rc).decode()}")


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--iters", type=int, default=512)
  ap.add_argument("--reps", type=int, default=5)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return 1
  import subprocess
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  print(card)
  lib = bind()
  threads = lib.spartan_dsmem_probe_threads()
  props = torch.cuda.get_device_properties(0)
  sms = props.multi_processor_count
  x = torch.rand(X_FLOATS, device="cuda")
  stream = torch.cuda.current_stream().cuda_stream

  def rate(mode, blocks, cluster=1, window=0):
    out = torch.empty(blocks * threads, device="cuda")

    def run():
      checked(lib, lib.spartan_dsmem_probe(
          mode, blocks, cluster, window, x.data_ptr(), X_FLOATS, args.iters,
          out.data_ptr(), stream), f"mode {mode} cluster {cluster}")
    run()
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.reps):
      a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      a.record()
      run()
      b.record()
      b.synchronize()
      ms.append(a.elapsed_time(b))
    t = statistics.median(ms)
    gathers = blocks * threads * args.iters * 8
    return gathers / (t * 1e-3), t, bool(torch.isfinite(out).all())

  result = {"card": card, "sms": sms, "threads": threads,
            "gathers_per_thread": args.iters * 8}
  g, t, ok = rate(0, 2 * sms)
  result["l2"] = {"rate": g, "ms": t, "blocks": 2 * sms, "finite": ok}
  print(f"(a) L2, x of {X_FLOATS} floats, {2 * sms} blocks of {threads}: "
        f"{g / 1e9:.2f} G gathers/s ({t:.4f} ms); {card}")
  g, t, ok = rate(1, sms, 1, WINDOW)
  result["shared"] = {"rate": g, "ms": t, "blocks": sms, "finite": ok}
  print(f"(b) own shared memory, {WINDOW} floats, {sms} blocks: "
        f"{g / 1e9:.2f} G gathers/s ({t:.4f} ms); {card}")
  result["cluster"] = {}
  chosen = None
  for c in CLUSTERS:
    active = ctypes.c_int(0)
    checked(lib, lib.spartan_dsmem_probe_clusters(c, WINDOW,
                                                  ctypes.byref(active)),
            f"occupancy of clusters of {c}")
    n = active.value
    if n == 0:
      print(f"(c) clusters of {c}: no cluster fits at {WINDOW * 4} bytes")
      result["cluster"][c] = {"active": 0}
      continue
    g, t, ok = rate(2, n * c, c, WINDOW)
    covered = n * c
    result["cluster"][c] = {"active": n, "sms": covered, "rate": g, "ms": t,
                            "finite": ok}
    meets = g >= RULE_RATE and covered >= RULE_SMS
    if meets and chosen is None:
      chosen = c
    print(f"(c) clusters of {c} x {WINDOW} floats: {n} active clusters "
          f"({covered} SMs), {g / 1e9:.2f} G gathers/s ({t:.4f} ms); "
          f"meets the rule: {meets}; {card}")
  result["rule"] = {"rate": RULE_RATE, "sms": RULE_SMS, "cluster": chosen}
  print(f"rule: >= {RULE_RATE / 1e9:.0f} G gathers/s over >= {RULE_SMS} SMs: "
        + (f"met at clusters of {chosen}" if chosen else "not met"))
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
