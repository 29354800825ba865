"""spartan_tpu_torch: the PyTorch and CUDA port of spartan-tpu.

The lazy NumPy-style expression DAG of ``spartan_tpu`` (creation,
elementwise map, reduce, dot, sparse × dense products), its fusion
passes and region evaluator, run on one ``torch.device`` — an NVIDIA GPU by
default — with the TPU's Pallas kernels replaced by hand-written CUDA
kernels.  ``spartan_tpu`` stays the
reference the port is tested against; this package never imports jax.

    import spartan_tpu_torch as sp
    sp.initialize()                      # --device=cuda by default
    b = sp.from_numpy(host_array)
    print(abs(1 + b * 2).sum().glom())   # fused map+reduce, one kernel

The slices of the reference surface ported so far are here (see
ROADMAP.md): the builtins, the loops, autodiff (``sp.grad`` and its kin,
``sp.compile``, ``sp.minimize``, ``sp.sgd_train``, ``sp.remat``), the sparse
arrays with ``sp.sparse``'s builders, ``sp.sparse.linalg``'s solvers and
``sp.sparse.csgraph``, ``sp.linalg``,
``sp.fft``, ``sp.random``, ``sp.scipy_linalg``, ``sp.optimize``,
``sp.integrate``, ``sp.special``, ``sp.stats``, ``sp.signal``,
``sp.ndimage``, ``sp.spatial`` (with ``spatial.distance`` and
``spatial.transform``) and array files; names not yet ported are absent
rather than stubbed.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from spartan_tpu_torch import util
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core import (Mesh, SpartanArray, TileExtent, Tiling,
                                    get_mesh, make_mesh, set_default_mesh,
                                    with_mesh)

__version__ = "0.1.0"


def initialize(argv: Optional[List[str]] = None, mesh: Optional[Mesh] = None
               ) -> None:
  """Parse flags and install the default mesh.

  The mesh is ``FLAGS.device`` (default ``cuda``) cut into the logical
  shards ``FLAGS.mesh_shape`` asks for (default one); if that device is
  absent this raises instead of carrying on elsewhere.  TF32 is
  switched off for matmuls and convolutions, so float32 math is full
  float32 on the card.
  """
  FLAGS.parse(argv)
  util.set_log_level(FLAGS.log_level)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  set_default_mesh(mesh if mesh is not None else make_mesh())


def shutdown() -> None:
  set_default_mesh(None)


from spartan_tpu_torch.expr.builtins import *  # noqa: F401,F403,E402
from spartan_tpu_torch.expr.builtins import __all__ as _builtin_all  # noqa: E402
from spartan_tpu_torch.expr.base import (DictExpr, Expr,  # noqa: E402
                                         ListExpr, NotShapeable, TupleExpr,
                                         Val, evaluate, force, lazify)
from spartan_tpu_torch.expr.map import map  # noqa: E402,A004
from spartan_tpu_torch.expr.reduce import reduce  # noqa: E402,A004
from spartan_tpu_torch.expr.loop import (cond, fori_loop,  # noqa: E402
                                         make_fori, scan_iters, while_loop)
from spartan_tpu_torch.expr.remat import remat  # noqa: E402
from spartan_tpu_torch.autodiff import compile_fn as compile  # noqa: E402,A001
from spartan_tpu_torch.autodiff import (grad, hessian, hvp,  # noqa: E402
                                        jvp, minimize, sgd_train,
                                        value_and_grad)
from spartan_tpu_torch import interop  # noqa: E402
from spartan_tpu_torch.backend import sparse  # noqa: E402
from spartan_tpu_torch.backend.sparse import (SparseArray,  # noqa: E402
                                              sparse_diagonal, sprandn)
from spartan_tpu_torch.expr.fio import (checkpoint, from_file,  # noqa: E402
                                        load, save)
from spartan_tpu_torch import linalg  # noqa: E402  (np.linalg surface)
from spartan_tpu_torch import fft  # noqa: E402  (np.fft / scipy.fft surface)
from spartan_tpu_torch import random  # noqa: E402,A004  (np.random surface)
from spartan_tpu_torch import sparse_linalg  # noqa: E402
sparse.linalg = sparse_linalg  # the scipy idiom: sp.sparse.linalg.cg(...)
from spartan_tpu_torch import sparse_construct  # noqa: E402
for _name in sparse_construct.__all__:  # the scipy.sparse builders
  setattr(sparse, _name, getattr(sparse_construct, _name))
from spartan_tpu_torch import csgraph  # noqa: E402  (scipy.sparse.csgraph)
sparse.csgraph = csgraph  # the scipy idiom: sp.sparse.csgraph.dijkstra(...)
from spartan_tpu_torch import scipy_linalg  # noqa: E402  (scipy.linalg)
for _name in scipy_linalg.__all__:
  # merge the non-conflicting names into sp.linalg; an overlapping name
  # (cholesky, qr, solve, solve_triangular, ...) keeps sp.linalg's own
  if not hasattr(linalg, _name):
    setattr(linalg, _name, getattr(scipy_linalg, _name))
del _name
from spartan_tpu_torch import optimize  # noqa: E402  (scipy.optimize)
from spartan_tpu_torch import integrate  # noqa: E402  (scipy.integrate)
from spartan_tpu_torch import special  # noqa: E402  (scipy.special)
from spartan_tpu_torch import stats  # noqa: E402  (scipy.stats)
from spartan_tpu_torch import signal  # noqa: E402  (scipy.signal)
from spartan_tpu_torch import ndimage  # noqa: E402  (scipy.ndimage)
from spartan_tpu_torch import spatial  # noqa: E402  (scipy.spatial)

__all__ = ["initialize", "shutdown", "FLAGS", "util", "TileExtent", "Tiling",
           "Mesh", "SpartanArray", "get_mesh", "make_mesh", "with_mesh",
           "Expr", "ListExpr", "TupleExpr", "DictExpr", "NotShapeable", "Val", "evaluate", "force",
           "lazify", "map",
           "reduce", "fori_loop", "make_fori", "while_loop", "scan_iters",
           "cond", "remat", "compile", "grad", "value_and_grad", "jvp",
           "hessian", "hvp", "minimize", "sgd_train", "checkpoint", "from_file", "load", "save", "interop",
           "sparse", "linalg", "fft", "random", "sparse_linalg", "scipy_linalg",
           "optimize", "integrate", "special", "stats", "signal",
           "ndimage", "spatial",
           "SparseArray", "sparse_diagonal", "sprandn"] + list(_builtin_all)
