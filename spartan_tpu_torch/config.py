"""Global flag registry.

PyTorch port of ``spartan_tpu/config.py``: the same declarative registry
(typed flags registered at import time, parsed from argv).  Values overlay
from (lowest to highest precedence): declared default → environment
(``SPARTAN_<NAME>``) → argv (``--name=value``) → programmatic assignment.

The flags that steered TPU code generation (``use_pallas``,
``pallas_interpret``, ``platform``) are replaced by ``use_kernels`` and
``device``; the semantic and optimizer flags keep their names and meaning.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional


class Flag:
  """A single typed flag."""

  def __init__(self, name: str, default: Any, help: str = "",
               parser: Optional[Callable[[str], Any]] = None):
    self.name = name
    self.default = default
    self.help = help
    self._parser = parser or type(default)
    self._value = None
    self._is_set = False
    env = os.environ.get("SPARTAN_" + name.upper())
    if env is not None:
      self.set(self.parse(env))

  def parse(self, text: str) -> Any:
    if isinstance(self.default, bool):
      return text.strip().lower() in ("1", "true", "yes", "on")
    return self._parser(text)

  def set(self, value: Any) -> None:
    self._value = value
    self._is_set = True

  def reset(self) -> None:
    self._value = None
    self._is_set = False

  @property
  def value(self) -> Any:
    return self._value if self._is_set else self.default


def BoolFlag(name: str, default: bool = False, help: str = "") -> Flag:
  return Flag(name, bool(default), help)


def IntFlag(name: str, default: int = 0, help: str = "") -> Flag:
  return Flag(name, int(default), help)


def FloatFlag(name: str, default: float = 0.0, help: str = "") -> Flag:
  return Flag(name, float(default), help)


def StrFlag(name: str, default: str = "", help: str = "") -> Flag:
  return Flag(name, str(default), help)


class Flags:
  """Registry of :class:`Flag` objects, attribute-accessible by name."""

  def __init__(self):
    object.__setattr__(self, "_flags", {})

  def add(self, flag: Flag) -> Flag:
    existing = self._flags.get(flag.name)
    if existing is not None:
      return existing
    self._flags[flag.name] = flag
    return flag

  def __getattr__(self, name: str) -> Any:
    flags: Dict[str, Flag] = object.__getattribute__(self, "_flags")
    if name in flags:
      return flags[name].value
    raise AttributeError(f"no flag {name!r} registered")

  def __setattr__(self, name: str, value: Any) -> None:
    flags = self._flags
    if name not in flags:
      raise AttributeError(f"no flag {name!r} registered")
    flags[name].set(value)

  def __contains__(self, name: str) -> bool:
    return name in self._flags

  def lookup(self, name: str) -> Flag:
    return self._flags[name]

  def parse(self, argv: Optional[List[str]] = None) -> List[str]:
    """Consume ``--name=value`` / ``--name value`` / ``--[no]boolflag``
    arguments that match registered flags; return the remainder."""
    if argv is None:
      return []
    rest: List[str] = []
    i = 0
    while i < len(argv):
      arg = argv[i]
      if not arg.startswith("--"):
        rest.append(arg)
        i += 1
        continue
      body = arg[2:]
      if "=" in body:
        name, _, text = body.partition("=")
        name = name.replace("-", "_")
        if name in self._flags:
          f = self._flags[name]
          f.set(f.parse(text))
          i += 1
          continue
      else:
        name = body.replace("-", "_")
        if name in self._flags:
          f = self._flags[name]
          if isinstance(f.default, bool):
            f.set(True)
            i += 1
            continue
          if i + 1 < len(argv):
            f.set(f.parse(argv[i + 1]))
            i += 2
            continue
        if name.startswith("no") and name[2:] in self._flags:
          f = self._flags[name[2:]]
          if isinstance(f.default, bool):
            f.set(False)
            i += 1
            continue
      rest.append(arg)
      i += 1
    return rest

  def reset_all(self) -> None:
    for f in self._flags.values():
      f.reset()

  def snapshot(self) -> Dict[str, Any]:
    return {name: f.value for name, f in self._flags.items()}


FLAGS = Flags()

FLAGS.add(BoolFlag("optimization", True, "master switch for DAG optimizer"))
FLAGS.add(BoolFlag("opt_fusion", True, "fuse map/map chains into one node"))
FLAGS.add(BoolFlag("opt_reduce_fusion", True, "fuse map into reduce kernels"))
FLAGS.add(BoolFlag("opt_collapse_cached", True,
                   "collapse already-evaluated sub-DAGs into leaves"))
FLAGS.add(BoolFlag("opt_auto_tiling", True,
                   "tiling pass (a no-op: dense arrays stay whole tensors)"))
FLAGS.add(BoolFlag("opt_affine_reduce", True,
                   "strength-reduce sum(a*x+b) to a*sum(x)+b*n — linear "
                   "reductions run at pure-sum memory speed"))
FLAGS.add(BoolFlag("opt_const_fold", True,
                   "fold broadcast-neutral fill-creations into scalar "
                   "leaves inside fused kernels"))
FLAGS.add(BoolFlag("float64_reductions", True,
                   "accumulate reductions in float64 (reference semantics); "
                   "disable for float32 accumulation"))
FLAGS.add(IntFlag("log_level", 20, "python logging level (10=debug)"))
FLAGS.add(StrFlag("device", "cuda",
                  "torch device of the mesh ('cuda', 'cuda:1', 'cpu'); "
                  "initialize() raises when the device is absent"))
FLAGS.add(StrFlag("mesh_shape", "",
                  "shape of the default mesh, e.g. '2x4': that many logical "
                  "shards of the one device; empty means one shard"))
FLAGS.add(BoolFlag("use_kernels", True,
                   "route hot ops through the hand-written CUDA kernels "
                   "(CPU tensors take the kernels' plain torch versions)"))
FLAGS.add(IntFlag("max_expr_cache", 1024, "max cached region runners"))
FLAGS.add(IntFlag("max_fused_kernel_ops", 128,
                  "stop splicing map kernels beyond this op count"))
FLAGS.add(StrFlag("sort_method", "auto",
                  "sort/percentile lowering: 'gather' and 'auto' take one "
                  "torch.sort of the whole array (the reference's gather "
                  "lowering); 'sample' (the distributed sample sort) is not "
                  "ported and raises"))
FLAGS.add(StrFlag("dot_precision", "default",
                  "matmul precision for float inputs: 'default', 'high' and "
                  "'highest' all run full float32 on the port (TF32 is "
                  "off); per-call sp.dot(precision=...) overrides"))
# Sparse routing.  The names, defaults and thresholds are the reference's
# (measured on a TPU v5e, to be measured again on the H100); the force
# flags keep the reference's names and route to the CUDA counterparts of
# the one-hot (K3a: ELL kernel), windowed (K3b: CSR kernel) and windowed
# SpMM (K5a: CSR SpMM kernel) TPU kernels.
FLAGS.add(BoolFlag("sparse_auto_bsr", True,
                   "on a CUDA device, detect block structure in a sparse "
                   "matrix and route its SpMV/SpMM to the block-ELL einsum"))
FLAGS.add(FloatFlag("sparse_bsr_max_expansion", 16.0,
                    "max stored elements per nonzero that the block-ELL "
                    "repack may pay; above it SpMV/SpMM stay on the ELL/CSR "
                    "kernels"))
FLAGS.add(BoolFlag("sparse_force_windowed", False,
                   "route SpMV through the CSR kernel (K3b) whatever the "
                   "size or device; on the CPU it runs its plain version "
                   "— testing/debug"))
FLAGS.add(BoolFlag("sparse_dense_route", True,
                   "let SpMV/SpMM densify moderately dense sparse matrices "
                   "on a CUDA device and multiply with torch.matmul (see "
                   "sparse_dense_min_density[_spmv]/max_bytes)"))
FLAGS.add(BoolFlag("sparse_force_winmm", False,
                   "route spmm/SpMMExpr through the CSR SpMM kernel (K5a) "
                   "whatever the device; on the CPU it runs its plain "
                   "version — testing/debug"))
FLAGS.add(FloatFlag("sparse_dense_min_density", 2e-3,
                    "min nnz/(n*m) for the densified SpMM route; below it "
                    "SpMM takes the CSR kernel (K5a) or the ELL gather"))
FLAGS.add(IntFlag("sparse_dense_max_bytes", 2 << 30,
                  "max float32 bytes (4*n*m) the densified route may "
                  "materialize on the device; larger matrices stay sparse"))
FLAGS.add(FloatFlag("sparse_dense_min_density_spmv", 8e-3,
                    "min nnz/(n*m) for the densified SpMV route; below it "
                    "SpMV takes the ELL/CSR kernels"))
FLAGS.add(BoolFlag("sparse_force_dense", False,
                   "route SpMV/SpMM through the densified torch.matmul "
                   "whatever the device or density — testing/debug"))
FLAGS.add(BoolFlag("sparse_force_onehot", False,
                   "route SpMV through the ELL kernel (K3a) whatever the "
                   "size or device; on the CPU it runs its plain version "
                   "— testing/debug"))
