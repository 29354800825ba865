"""Build and load the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  On
first use it is compiled with ``nvcc`` (several sources in parallel through
:func:`load_all`) into a shared library under
``spartan_tpu_torch/_build/`` (named by a hash of the sources and flags, so
an edit rebuilds) and loaded with ``ctypes``; :func:`launch` binds and calls
its ``spartan_<name>`` entry point.  No PyTorch headers are involved, so a
build takes seconds.  ``nvcc`` comes from ``CUDA_HOME``,
then ``PATH``, then ``/usr/local/cuda/bin``; without one the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: division and sqrt stay IEEE-rounded.  -Xptxas -v
# records registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
  home = os.environ.get("CUDA_HOME")
  if home and (Path(home) / "bin" / "nvcc").is_file():
    return str(Path(home) / "bin" / "nvcc")
  found = shutil.which("nvcc")
  if found:
    return found
  if Path("/usr/local/cuda/bin/nvcc").is_file():
    return "/usr/local/cuda/bin/nvcc"
  raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                     "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest(name: str) -> str:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  h.update((CSRC / f"{name}.cu").read_bytes())
  for header in sorted(CSRC.glob("*.cuh")):
    h.update(header.read_bytes())
  return h.hexdigest()[:16]


def library_path(name: str) -> Path:
  return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_log(name: str) -> str:
  """The compiler's output (ptxas register/spill report) of the last build
  of ``name`` in this checkout, or '' if it was not built here."""
  log = library_path(name).with_suffix(".log")
  return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
  """The loaded library for ``csrc/<name>.cu``, building it if needed."""
  lib = _libs.get(name)
  if lib is None:
    lib = load_all([name])[name]
  return lib


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
  """The loaded libraries for ``names``.  Those not built yet are compiled
  at once, one ``nvcc`` process per source, all started together."""
  nvcc = None
  started = []
  for name in names:
    if name in _libs:
      continue
    so = library_path(name)
    if so.is_file():
      continue
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    log = so.with_name(f"{so.name}.{os.getpid()}.log")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as out:
      proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    started.append((name, so, tmp, log, proc, time.perf_counter()))
  failed = []
  for name, so, tmp, log, proc, t0 in started:
    rc = proc.wait()
    build_seconds[name] = time.perf_counter() - t0
    if rc != 0:
      failed.append(f"nvcc failed building {name} (exit {rc}):\n"
                    f"{log.read_text()}")
      continue
    os.replace(log, so.with_suffix(".log"))
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial .so
  if failed:
    raise RuntimeError("\n".join(failed))
  for name in names:
    if name not in _libs:
      _libs[name] = ctypes.CDLL(str(library_path(name)))
  return {name: _libs[name] for name in names}


def one_device(*tensors: torch.Tensor) -> None:
  """Raise unless every operand of a kernel wrapper lies on one device
  (checked before the wrapper picks kernel or plain version by that
  device)."""
  devices = {t.device for t in tensors}
  if len(devices) != 1:
    raise ValueError(f"kernel operands must share one device, got "
                     f"{sorted(map(str, devices))}")


# The C signature of each ``spartan_<name>`` launched through :func:`launch`,
# less the trailing stream.  Pointers as c_void_p: ctypes would cut them to
# 32 bits.
ARGTYPES = {
    "spmv_ell": [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int],
    "spmv_csr": [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int],
    "spmm_csr": [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int],
    "stencil3x3": [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int],
    "stencil3x3_padded": [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int],
    "matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "spmv_chunked": [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int],
}
# name -> (bound C function, its library), filled at the first launch
_bound: Dict[str, Tuple[Any, ctypes.CDLL]] = {}


def launch(name: str, device: torch.device, *args) -> None:
  """Launch ``spartan_<name>(*args, stream)`` on ``device``'s current
  stream; raises if the launch fails.  The library is built and bound at
  the first call only."""
  if name not in _bound:
    lib = load(name)
    fn = getattr(lib, f"spartan_{name}")
    fn.argtypes = ARGTYPES[name] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.spartan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.spartan_cuda_error_string.restype = ctypes.c_char_p
    _bound[name] = (fn, lib)
  fn, lib = _bound[name]
  if device.index == torch.cuda.current_device():
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
  else:
    with torch.cuda.device(device):
      rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
  if rc != 0:
    raise RuntimeError(f"{name} kernel launch failed: "
                       + lib.spartan_cuda_error_string(rc).decode())
