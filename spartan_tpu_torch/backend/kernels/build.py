"""Build and load the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  On
first use it is compiled with ``nvcc`` into a shared library under
``spartan_tpu_torch/_build/`` (named by a hash of the sources and flags, so
an edit rebuilds) and loaded with ``ctypes``.  No PyTorch headers are
involved, so a build takes seconds.  ``nvcc`` comes from ``CUDA_HOME``,
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
from typing import Dict

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
  if lib is not None:
    return lib
  so = library_path(name)
  if not so.is_file():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed building {name} "
                         f"(exit {proc.returncode}):\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial .so
  lib = ctypes.CDLL(str(so))
  _libs[name] = lib
  return lib
