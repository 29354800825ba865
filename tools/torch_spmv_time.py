"""Times the SpMV kernels K3a, K3a sharded, K3b, K3c and K3d beside
cuSPARSE on the card, for the package under a given checkout, so that two
versions can be held side by side in one chip call (card only).

    python3 tools/torch_spmv_time.py [ROOT] [--ablations] [--reps 7]

ROOT (default: this checkout) is the directory that holds the
``spartan_tpu_torch`` to time; its kernels build into its own ``_build``.
The inputs are chip_smoke.py's, made from its seeds: the urand 2^22 graph
(67.1 M nonzeros, x of 2^22 floats), the transpose of the ratings of
MovieLens 20M's shape (26,744 x 138,493, 20.0 M nonzeros) and the urand
graph at n = 32768 (K3a's ELL, k = 36).  Through the entry points both
versions have (``spmv_csr``, ``make_spmv_windowed`` over
``pack_windowed_unique``, ``sharded_windowed_spmv_traced`` over
``pack_windowed_sharded`` at p = 2, 4, 8, ``spmv_ell`` and
``sharded_onehot_spmv`` at p = 2, 4, 8), it prints the median over
``--reps`` of the device time of one call (CUDA events over 20 calls
queued behind a spin kernel, in turns) and a digest of each result's
bytes, so that two versions' bits can be compared.

It also times K3a on the same graph with rows of k = 35 (cut) and 37
(padded), whose rows do not start on 16 bytes.

``--ablations`` (this checkout only) first times K3a at n = 32768 in the
launch forms its entry point takes, given by hand: x copied whole into
each block's shared memory with 16-byte loads (the wrapper's form) against
the through-L1 form (the design before: x gathered through L1, 4-byte
loads, 32 lanes a row), 16-byte loads at the other G of 8, 16 and 32 lanes
a row, and the same pieces with 4-byte loads; at k = 35 and 37, the
on-chip form's 4-byte loads against the through-L1 form.  Each form's
result digest is printed, so that the forms that keep the sum order can
be seen to give the same bits.  It then builds variants of this
checkout's ``csrc/spmv_ell.cu``, ``csrc/spmv_csr.cu`` and
``csrc/spmv_chunked.cu``, each with one text changed, into a temporary
directory, and times each in turns with the kernel as it is: K3a
gathering x through L1 with its 16-byte loads, K3a with blocks of 1024
threads and 4 rows a slot and of 512 threads and 4 rows a slot (512 and 8
as it is); K3b loading 1, 4 or 16 entries of a long row at a time (8 as
it is); K3c with its loads of the stream and x issued after the row
marks, without the stream's evict-first hint, and with chunks of 128
threads, 8 nonzeros a thread.  It then times K3b with G = 4, 8, 16 and 32
lanes a row on the urand graph, and K3d at p = 8 as one launch and as a
launch a band.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

# variant -> (source, text of the kernel as it is, the variant's text: every
# occurrence replaced)
VARIANTS = {
    "K3b 1 entry at a time": ("spmv_csr", "constexpr int kUnroll = 8;",
                              "constexpr int kUnroll = 1;"),
    "K3b 4 entries at a time": ("spmv_csr", "constexpr int kUnroll = 8;",
                                "constexpr int kUnroll = 4;"),
    "K3b 16 entries at a time": ("spmv_csr", "constexpr int kUnroll = 8;",
                                 "constexpr int kUnroll = 16;"),
    "K3c loads after the marks": ("spmv_chunked",
                                  "constexpr bool kLoadsFirst = true;",
                                  "constexpr bool kLoadsFirst = false;"),
    "K3c no stream hint": ("spmv_chunked", "__ldcs(", "__ldg("),
    "K3c 128 threads, 8 a thread": (
        "spmv_chunked", "constexpr int kThreads = 256;\nconstexpr int kPer = 4;",
        "constexpr int kThreads = 128;\nconstexpr int kPer = 8;"),
    "K3a x through L1, 16-byte loads": ("spmv_ell", "add(acc, xs, ",
                                        "add(acc, t.x, "),
    "K3a 1024 threads, 4 rows a slot": (
        "spmv_ell", "constexpr int kThreads = 512;\nconstexpr int kRows = 8;",
        "constexpr int kThreads = 1024;\nconstexpr int kRows = 4;"),
    "K3a 512 threads, 4 rows a slot": (
        "spmv_ell", "constexpr int kRows = 8;", "constexpr int kRows = 4;"),
}


def build_variants(build, root: Path):
  """Each variant's library, one nvcc per variant, started together."""
  procs = {}
  for i, (name, (source, text, variant)) in enumerate(VARIANTS.items()):
    src = root / f"variant{i}"
    shutil.copytree(build.CSRC, src)
    path = src / f"{source}.cu"
    body = path.read_text()
    if text not in body:
      raise RuntimeError(f"{source}.cu: {text!r} is not there")
    path.write_text(body.replace(text, variant))
    so = src / f"lib{source}.so"
    procs[name] = (source, so, subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
  libs = {}
  for name, (source, so, proc) in procs.items():
    log = proc.communicate()[0]
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    libs[name] = (source, ctypes.CDLL(str(so)))
  return libs


def bind(build, source: str, lib):
  """``build._bound``'s entry for ``lib``'s entry point of ``source``."""
  fn = getattr(lib, f"spartan_{source}")
  fn.argtypes = build.ARGTYPES[source] + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  lib.spartan_cuda_error_string.argtypes = [ctypes.c_int]
  lib.spartan_cuda_error_string.restype = ctypes.c_char_p
  return fn, lib


def digest(y: torch.Tensor) -> str:
  return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:12]


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("root", nargs="?", default=str(HERE))
  ap.add_argument("--ablations", action="store_true")
  ap.add_argument("--reps", type=int, default=7)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return 1
  root = str(Path(args.root).resolve())
  if args.ablations and Path(root) != HERE:
    raise SystemExit("--ablations builds variants of this checkout only")
  sys.path.insert(0, root)
  import spartan_tpu_torch as sp
  from spartan_tpu_torch.backend.kernels import build
  from spartan_tpu_torch.backend.kernels import spmv as KS
  if not KS.__file__.startswith(root):
    raise RuntimeError(f"imported {KS.__file__}, not the package in {root}")
  sys.path.insert(1, str(HERE))
  import chip_smoke as cs  # its inputs and timing, over the package above
  sp.initialize(["--device=cuda"])
  card = cs.card_line()
  device = sp.get_mesh().device
  gen = torch.Generator(device=device).manual_seed(61)
  big = cs.urand_graph(cs.PR_BIG_N, 1)
  RT = cs.movielens_shaped(device).T.tocsr()
  mats = {}
  for label, A in (("urand 2^22", big), ("ML-20M R.T", RT)):
    whole = KS.pack_windowed(A)
    unique = KS.pack_windowed_unique(A)
    x = torch.randn(A.shape[1], generator=gen, device=device)
    lib = torch.sparse_csr_tensor(whole.indptr.int(), whole.indices,
                                  whole.data, size=A.shape,
                                  check_invariants=False)
    mats[label] = (A, whole, unique, x, lib)
    print(f"{label}: {A.shape[0]} x {A.shape[1]}, nnz {A.nnz}; unique pack "
          f"{unique!r}")
  del big, RT

  def line(label, t, names, y=None, inner=20):
    times = ", ".join(f"{name} {t[name]:.4f} ms" for name in names)
    ahead = all(t[f"{name} ahead"] for name in names)
    bits = f"; result digest {digest(y)}" if y is not None else ""
    print(f"{card}; root {root}; {label}: {times} (median of {args.reps} x "
          f"{inner} calls, CUDA events, in turns; queued ahead: {ahead})"
          f"{bits}")

  for label, (A, whole, unique, x, lib) in mats.items():
    csr = (whole.indptr, whole.indices, whole.data)
    k3c = KS.make_spmv_windowed(unique)
    chunked = (unique.indptr, unique.indices, unique.data, unique.chunk_row,
               x)
    t = cs.time_in_turns({"K3b": lambda: KS.spmv_csr(*csr, x),
                          "K3c": lambda: k3c(x),
                          "K3c unwindowed": lambda: KS.spmv_chunked(*chunked),
                          "cuSPARSE": lambda: lib @ x}, 20, args.reps)
    line(f"{label} K3b", t, ("K3b", "cuSPARSE"), KS.spmv_csr(*csr, x))
    line(f"{label} K3c", t, ("K3c",), k3c(x))
    line(f"{label} K3c unwindowed", t, ("K3c unwindowed",),
         KS.spmv_chunked(*chunked))
  A, whole, _, x, lib = mats["urand 2^22"]
  csr = (whole.indptr, whole.indices, whole.data)
  for p in (2, 4, 8):
    mesh = sp.make_mesh(device, shape=(p,))
    packed = KS.pack_windowed_sharded(A, p)
    KS.reset_counts()
    y = KS.sharded_windowed_spmv_traced(packed, x, mesh)
    launches = KS.counts["sharded_csr_launches"]
    t = cs.time_in_turns({
        "K3d": lambda: KS.sharded_windowed_spmv_traced(packed, x, mesh),
        "K3b": lambda: KS.spmv_csr(*csr, x)}, 20, args.reps)
    line(f"urand 2^22 K3d p = {p} ({launches} launches a call)", t,
         ("K3d", "K3b"), y)

  from spartan_tpu_torch.backend import sparse
  small = sparse.from_scipy(cs.urand_graph(cs.PR_SMALL_N, 2))
  cols, vals = small.cols, small.vals
  n, k = cols.shape
  xa = torch.randn(small.shape[1], generator=gen, device=device)
  indptr, indices, data = small.to_csr()
  liba = torch.sparse_csr_tensor(indptr.int(), indices, data,
                                 size=small.shape, check_invariants=False)
  t = cs.time_in_turns({"K3a": lambda: KS.spmv_ell(cols, vals, xa),
                        "cuSPARSE": lambda: liba @ xa}, 200, args.reps)
  line(f"urand 32768 K3a (k = {k})", t, ("K3a", "cuSPARSE"),
       KS.spmv_ell(cols, vals, xa), 200)
  for p in (2, 4, 8):
    mesh = sp.make_mesh(device, shape=(p,))
    t = cs.time_in_turns({
        "K3a sharded": lambda: KS.sharded_onehot_spmv(cols, vals, xa, mesh),
        "K3a": lambda: KS.spmv_ell(cols, vals, xa)}, 200, args.reps)
    line(f"urand 32768 K3a sharded p = {p}", t, ("K3a sharded", "K3a"),
         KS.sharded_onehot_spmv(cols, vals, xa, mesh), 200)
  # rows off 16-byte boundaries: the same graph cut to 35 entries a row and
  # padded to 37
  odd = {}
  for kk in (35, 37):
    c = torch.zeros((n, kk), dtype=torch.int32, device=device)
    v = torch.zeros((n, kk), device=device)
    c[:, :min(k, kk)], v[:, :min(k, kk)] = (cols[:, :kk], vals[:, :kk])
    odd[kk] = (c, v)
  t = cs.time_in_turns({f"K3a k = {kk}": (lambda c=c, v=v: KS.spmv_ell(
      c, v, xa)) for kk, (c, v) in odd.items()}, 200, args.reps)
  for kk, (c, v) in odd.items():
    line(f"urand 32768 K3a (k = {kk})", t, (f"K3a k = {kk}",),
         KS.spmv_ell(c, v, xa), 200)
  if not args.ablations:
    return 0

  def ell_form(on_chip, vec, group, c=cols, v=vals):
    """K3a's entry point over one band with its launch form given."""
    y = torch.empty(n, device=device)
    flat = (ctypes.c_int64 * 4)(*KS.band_table(c, v, y, [(0, n)])[0])

    def run():
      build.launch("spmv_ell", device, ctypes.addressof(flat), 1,
                   xa.data_ptr(), xa.shape[0], c.shape[1], group, vec,
                   on_chip)
      return y
    return run

  g = KS.group_size(k // 4)
  forms = {f"x in shared memory, 16-byte loads, G = {g}": ell_form(1, 4, g),
           "through L1 (before)": ell_form(0, 1, KS.group_size(k))}
  for group in (8, 16, 32):
    if group != g:
      forms[f"16-byte loads, G = {group}"] = ell_form(1, 4, group)
  forms[f"4-byte loads, G = {g}"] = ell_form(1, 1, g)
  for kk, (c, v) in odd.items():
    forms[f"k = {kk}, x in shared memory, 4-byte loads"] = ell_form(
        1, 1, KS.group_size(-(-kk // 4)), c, v)
    forms[f"k = {kk}, through L1 (before)"] = ell_form(
        0, 1, KS.group_size(kk), c, v)
  t = cs.time_in_turns(forms, 200, args.reps)
  for name, fn in forms.items():
    line("urand 32768 K3a form", t, (name,), fn(), 200)

  with tempfile.TemporaryDirectory() as tmp:
    libs = build_variants(build, Path(tmp))
    as_is = {source: bind(build, source, build.load(source))
             for source in ("spmv_csr", "spmv_chunked", "spmv_ell")}

    def routed(source, entry, fn):
      def run():
        build._bound[source] = entry
        return fn()
      return run

    for name, (source, lib) in libs.items():
      entry = bind(build, source, lib)
      if source == "spmv_ell":
        cases = {"urand 32768": lambda: KS.spmv_ell(cols, vals, xa)}
      elif source == "spmv_csr":
        cases = {label: (lambda w=whole, v=x_m: KS.spmv_csr(
            w.indptr, w.indices, w.data, v))
                 for label, (_, whole, _, x_m, _) in mats.items()}
      else:
        cases = {label: (lambda u=unique, v=x_m: KS.make_spmv_windowed(u)(v))
                 for label, (_, _, unique, x_m, _) in mats.items()}
      for label, fn in cases.items():
        inner = 200 if source == "spmv_ell" else 20
        want = routed(source, as_is[source], fn)()
        got = routed(source, entry, fn)()
        torch.cuda.synchronize()
        t = cs.time_in_turns({"as is": routed(source, as_is[source], fn),
                              name: routed(source, entry, fn)}, inner,
                             args.reps)
        line(f"{label} ablation", t, ("as is", name), inner=inner)
        print(f"  {name} on {label}: bit-equal to the kernel as it is: "
              f"{bool(torch.equal(got, want))}")
    build._bound.update(as_is)
    groups = {f"G = {g}": (lambda g=g: KS.spmv_csr(*csr, x, group=g))
              for g in (4, 8, 16, 32)}
    t = cs.time_in_turns(groups, 20, args.reps)
    line(f"urand 2^22 K3b lanes a row (the wrapper takes "
         f"G = {KS.group_size(A.nnz / A.shape[0])})", t, tuple(groups))
    packed = KS.pack_windowed_sharded(A, 8)
    y = torch.empty(A.shape[0], device=device)
    bands = KS.csr_bands(packed, y)
    group = packed.group
    t = cs.time_in_turns({
        "1 launch": lambda: KS._launch_csr_bands(bands, x, group),
        "a launch a band": lambda: [KS._launch_csr_bands([b], x, group)
                                    for b in bands]}, 20, args.reps)
    line("urand 2^22 K3d p = 8 launches", t, ("1 launch", "a launch a band"))
  return 0


if __name__ == "__main__":
  sys.exit(main())
