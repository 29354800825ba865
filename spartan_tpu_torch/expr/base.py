"""Lazy expression DAG (port of ``spartan_tpu/expr/base.py``).

A node does not execute itself; it knows how to *emit* torch ops for its
value given its children's values (:meth:`Expr._emit`).  The evaluator cuts
the DAG into regions, runs the optimizer once per structural signature, and
replays the emitters eagerly on the mesh's device.

Shape and dtype inference is uniform, as in the reference: the node's own
emitter runs over ``device="meta"`` tensors under ``EmitCtx(abstract=True)``
(the counterpart of ``jax.eval_shape``), so the emitter stays the single
source of truth.  Python scalars stay *weak* (NumPy semantics:
``f32_array * 2.0`` keeps float32): their abstract value is a Python scalar
of the same kind, never a tensor.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import SpartanArray, to_torch_dtype

_counter = itertools.count()

_PY_SCALAR_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float64,
                     complex: torch.complex128}
_WEAK_SAMPLES = {torch.bool: True, torch.int64: 1, torch.float64: 1.0,
                 torch.complex128: 1j}


class Aval:
  """Abstract value of a node: shape, dtype, and whether it is a weakly
  typed Python scalar."""

  __slots__ = ("shape", "dtype", "weak")

  def __init__(self, shape, dtype: torch.dtype, weak: bool = False):
    self.shape = tuple(int(s) for s in shape)
    self.dtype = dtype
    self.weak = weak

  @property
  def ndim(self) -> int:
    return len(self.shape)

  @property
  def key(self) -> Tuple:
    return (self.shape, str(self.dtype), self.weak)

  def abstract_value(self):
    """What an emitter receives for this value during shape inference."""
    if self.weak:
      return _WEAK_SAMPLES[self.dtype]
    return torch.empty(self.shape, dtype=self.dtype, device="meta")

  @staticmethod
  def of(value) -> "Aval":
    if isinstance(value, torch.Tensor):
      return Aval(value.shape, value.dtype)
    if type(value) in _PY_SCALAR_DTYPES:
      return Aval((), _PY_SCALAR_DTYPES[type(value)], weak=True)
    raise TypeError(f"emitter produced {type(value).__name__}, expected a "
                    "torch.Tensor or a Python scalar")

  def __repr__(self):
    return f"Aval({self.shape}, {self.dtype}{', weak' if self.weak else ''})"


_fn_key_cache: Dict[int, Tuple[Any, Tuple]] = {}


def fn_key(fn: Any) -> Tuple:
  """Structural identity of a kernel function, so semantically identical
  lambdas recreated across loop iterations still hit the region cache.
  Memoized per function object (the entry pins the function so its id
  stays valid)."""
  if fn is None:
    return ("none",)
  hit = _fn_key_cache.get(id(fn))
  if hit is not None and hit[0] is fn:
    return hit[1]
  if isinstance(fn, functools.partial):
    key = ("partial", fn_key(fn.func), _safe_repr(fn.args),
           _safe_repr(tuple(sorted(fn.keywords.items()))))
  else:
    code = getattr(fn, "__code__", None)
    if code is not None:
      # co_names matters: ``v.to(torch.float32)`` and ``...int32`` have
      # identical co_code.  Defaults live outside co_consts.
      defaults = (_safe_repr(getattr(fn, "__defaults__", None)),
                  _safe_repr(getattr(fn, "__kwdefaults__", None)))
      closure = getattr(fn, "__closure__", None) or ()
      cells = tuple(_safe_repr(c.cell_contents) for c in closure)
      key = ("fn", fn.__qualname__, code.co_code, code.co_names,
             _safe_repr(code.co_consts), defaults, cells)
      if closure:
        return key  # closures may mutate: never memoize them
    else:
      key = ("obj", getattr(fn, "__module__", ""),
             getattr(fn, "__name__", repr(fn)))
  if len(_fn_key_cache) > 4096:
    _fn_key_cache.clear()
  _fn_key_cache[id(fn)] = (fn, key)
  return key


# id()-keyed cache entries are only sound while the keyed object stays
# alive (a freed array's address can be recycled by another array), so
# every id-keyed object is pinned; when the pinned bytes pass the bound,
# the pins and every cache that may embed id-keys are flushed together.
_id_pins: Dict[int, Any] = {}
_id_pin_bytes = [0]
_ID_PIN_BYTE_LIMIT = 256 << 20


def _pin_id(obj: Any) -> int:
  oid = id(obj)
  if oid not in _id_pins:
    nbytes = int(getattr(obj, "nbytes", 256) or 256)
    if (_id_pin_bytes[0] + nbytes > _ID_PIN_BYTE_LIMIT
        or len(_id_pins) > 4096):
      from spartan_tpu_torch.backend import evaluator
      _id_pins.clear()
      _id_pin_bytes[0] = 0
      _aval_cache.clear()
      _fn_key_cache.clear()
      evaluator.clear_cache()
    _id_pins[oid] = obj
    _id_pin_bytes[0] += nbytes
  return oid


def _safe_repr(obj: Any) -> str:
  """Bounded repr for cache keys; large arrays key by pinned identity."""
  if isinstance(obj, (np.ndarray, torch.Tensor)):
    if obj.ndim == 0 or (obj.numel() if isinstance(obj, torch.Tensor)
                         else obj.size) <= 16:
      host = obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj
      return f"arr{tuple(obj.shape)}{obj.dtype}{host.tolist()}"
    return f"arr{tuple(obj.shape)}{obj.dtype}@{_pin_id(obj)}"
  if isinstance(obj, SpartanArray):
    return f"sp{obj.shape}{obj.dtype}@{_pin_id(obj)}"
  if isinstance(obj, Expr):
    return f"expr@{obj.expr_id}"
  if isinstance(obj, tuple):
    return "(" + ",".join(_safe_repr(x) for x in obj) + ")"
  if callable(obj) and not isinstance(obj, torch.dtype):
    return str(fn_key(obj))
  r = repr(obj)
  return r if len(r) <= 256 else r[:256] + f"...@{_pin_id(obj)}"


_aval_cache: Dict[Tuple, Aval] = {}


def semantic_flags_fingerprint() -> Tuple:
  """Flags that change emitted computations — part of every cache key."""
  return (FLAGS.float64_reductions, FLAGS.opt_affine_reduce,
          FLAGS.dot_precision, FLAGS.use_kernels, FLAGS.sparse_force_onehot,
          FLAGS.sparse_force_windowed, FLAGS.sparse_force_winmm,
          FLAGS.sparse_dense_route, FLAGS.sparse_force_dense)


class Expr:
  """Base lazy node.

  Subclasses define:
    * ``_members``: names of child-expression slots (DAG edges),
    * ``_params``:  names of non-expr attributes (part of the cache key),
    * ``_emit(ctx, deps)``: build torch ops from dep values.
  """

  _members: Tuple[str, ...] = ()
  _params: Tuple[str, ...] = ()
  # numpy-left operands (``ndarray * expr``) defer to the reflected dunders
  # instead of gathering the expr through ``__array__``
  __array_ufunc__ = None

  def __init__(self, **kw):
    self.expr_id = next(_counter)
    self._cache: Optional[SpartanArray] = None
    self._aval: Optional[Aval] = None
    for name in self._members:
      setattr(self, name, kw.pop(name))
    for name in self._params:
      setattr(self, name, kw.pop(name))
    if kw:
      raise TypeError(f"unexpected args for {type(self).__name__}: {kw}")

  # -- DAG structure --------------------------------------------------------

  def children(self) -> List["Expr"]:
    out: List[Expr] = []
    for name in self._members:
      v = getattr(self, name)
      if isinstance(v, Expr):
        out.append(v)
      elif isinstance(v, (list, tuple)):
        out.extend(c for c in v if isinstance(c, Expr))
    return out

  def replace(self, **kw) -> "Expr":
    """Copy with some members/params replaced (optimizer passes).  Keeps
    the abstract value: rewrites preserve shape and dtype."""
    new = type(self).__new__(type(self))
    new.expr_id = next(_counter)
    new._cache = None
    new._aval = self._aval
    for name in self._members + self._params:
      setattr(new, name, kw.pop(name, getattr(self, name)))
    if kw:
      raise TypeError(f"unknown fields for {type(self).__name__}: {kw}")
    return new

  def visit(self, fn: Callable[["Expr"], None],
            memo: Optional[set] = None) -> None:
    """Iterative post-order DAG visit."""
    memo = memo if memo is not None else set()
    stack = [(self, False)]
    while stack:
      node, expanded = stack.pop()
      if expanded:
        fn(node)
        continue
      if node.expr_id in memo:
        continue
      memo.add(node.expr_id)
      stack.append((node, True))
      for c in reversed(node.children()):
        if c.expr_id not in memo:
          stack.append((c, False))

  def signature(self, memo: Dict[Any, Any]) -> Tuple:
    """Structural cache key: shape/dtype of leaves, ops/params of interior
    nodes.  Iterative post-order; a shared node's later references collapse
    to a compact ordinal, so diamond-shared DAGs stay linear in size."""
    hit = memo.get(self.expr_id)
    if hit is not None:
      return hit
    result: Dict[int, Tuple] = {}
    stack = [(self, False)]
    while stack:
      node, expanded = stack.pop()
      if node.expr_id in memo:
        continue
      if expanded:
        sig = node._sig_local(memo, result)
        result[node.expr_id] = sig
        node._sig_store(memo, sig)
        continue
      stack.append((node, True))
      for c in reversed(node.children()):
        if c.expr_id not in memo:
          stack.append((c, False))
    return result[self.expr_id]

  def _child_sig(self, c: "Expr", memo, result):
    r = result.pop(c.expr_id, None)
    return r if r is not None else memo[c.expr_id]

  def _sig_store(self, memo, sig) -> None:
    ordinal = memo.get("__node_counter__", 0)
    memo["__node_counter__"] = ordinal + 1
    memo[self.expr_id] = ("ref", ordinal)

  def _sig_local(self, memo, result) -> Tuple:
    parts: List[Any] = [type(self).__name__]
    for name in self._params:
      v = getattr(self, name)
      sig_fn = getattr(v, "signature", None)
      if sig_fn is not None and not isinstance(v, Expr):
        parts.append((name, sig_fn()))  # LocalExpr kernels
      else:
        parts.append((name, _safe_repr(v)))
    for name in self._members:
      v = getattr(self, name)
      if isinstance(v, Expr):
        parts.append(self._child_sig(v, memo, result))
      elif isinstance(v, (list, tuple)):
        parts.append(tuple(self._child_sig(c, memo, result)
                           if isinstance(c, Expr) else _safe_repr(c)
                           for c in v))
      else:
        parts.append(_safe_repr(v))
    return tuple(parts)

  # -- shape/dtype inference ------------------------------------------------

  def _emit(self, ctx: "EmitCtx", deps: List[Any]):
    raise NotImplementedError(type(self).__name__)

  def aval(self) -> Aval:
    """Abstract value from the node's emitter over meta tensors; cached
    per node and globally by (node type, params, child avals)."""
    if self._aval is None:
      # fill descendants bottom-up first (iteratively), so inference below
      # recurses at most one level on deep chains
      order: List[Expr] = []
      self.visit(order.append)
      for n in order[:-1]:
        if n._aval is None:
          n.aval()
      dep_avals = [c.aval() for c in self.children()]
      parts: List[Any] = [type(self).__name__]
      for name in self._params:
        v = getattr(self, name)
        sig_fn = getattr(v, "signature", None)
        if sig_fn is not None and not isinstance(v, Expr):
          parts.append(sig_fn())
        else:
          parts.append(_safe_repr(v))
      key = (tuple(parts), tuple(a.key for a in dep_avals),
             semantic_flags_fingerprint())
      hit = _aval_cache.get(key)
      if hit is not None:
        self._aval = hit
        return hit
      ctx = EmitCtx(abstract=True, device=torch.device("meta"))
      self._aval = Aval.of(
          self._emit(ctx, [a.abstract_value() for a in dep_avals]))
      if len(_aval_cache) > 4096:
        _aval_cache.clear()
      _aval_cache[key] = self._aval
    return self._aval

  @property
  def shape(self) -> Tuple[int, ...]:
    return self.aval().shape

  @property
  def dtype(self) -> torch.dtype:
    return self.aval().dtype

  @property
  def ndim(self) -> int:
    return len(self.shape)

  @property
  def size(self) -> int:
    return int(np.prod(self.shape)) if self.shape else 1

  # -- evaluation -----------------------------------------------------------

  def evaluate(self) -> SpartanArray:
    from spartan_tpu_torch.backend import evaluator
    return evaluator.evaluate(self)

  force = evaluate

  def optimized(self) -> "Expr":
    from spartan_tpu_torch.expr import optimize as opt
    return opt.optimize(self)

  def glom(self) -> np.ndarray:
    return self.evaluate().glom()

  def __array__(self, dtype=None, copy=None):
    out = self.glom()
    return out.astype(dtype) if dtype is not None else out

  def item(self):
    return np.asarray(self.glom()).item()

  def __float__(self):
    if self.size != 1:
      raise TypeError("only size-1 exprs convert to float")
    return float(np.asarray(self.glom()).reshape(()))

  # -- numpy-flavoured methods (the slice's subset) --------------------------

  def astype(self, dtype) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.astype(self, dtype)

  @property
  def T(self) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.transpose(self)

  def transpose(self, *axes) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
      axes = tuple(axes[0])
    return B.transpose(self, axes or None)

  def reshape(self, *shape) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
      shape = tuple(shape[0])
    return B.reshape(self, shape)

  def ravel(self) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.ravel(self)

  def flatten(self) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.ravel(self)

  def sum(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.sum(self, axis=axis, keepdims=keepdims)

  def mean(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.mean(self, axis=axis, keepdims=keepdims)

  def max(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.max(self, axis=axis, keepdims=keepdims)

  def min(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.min(self, axis=axis, keepdims=keepdims)

  def argmax(self, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.argmax(self, axis=axis)

  def argmin(self, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.argmin(self, axis=axis)

  def dot(self, other) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.dot(self, other)

  # -- operators ------------------------------------------------------------

  def _binop(self, other, name: str, reverse: bool = False):
    from spartan_tpu_torch.expr import map as map_mod
    a, b = (other, self) if reverse else (self, other)
    return map_mod.map2(a, b, map_mod.BINARY[name])

  def _unop(self, name: str):
    from spartan_tpu_torch.expr import map as map_mod
    return map_mod.map1(self, map_mod.UNARY[name])

  def __add__(self, o): return self._binop(o, "add")
  def __radd__(self, o): return self._binop(o, "add", True)
  def __sub__(self, o): return self._binop(o, "subtract")
  def __rsub__(self, o): return self._binop(o, "subtract", True)
  def __mul__(self, o): return self._binop(o, "multiply")
  def __rmul__(self, o): return self._binop(o, "multiply", True)
  def __truediv__(self, o): return self._binop(o, "true_divide")
  def __rtruediv__(self, o): return self._binop(o, "true_divide", True)
  def __neg__(self): return self._unop("negative")
  def __abs__(self): return self._unop("absolute")
  def __pos__(self): return self

  def __matmul__(self, o):
    return self.dot(o)

  def __rmatmul__(self, o):
    from spartan_tpu_torch.expr import builtins as B
    return B.dot(o, self)

  __hash__ = None  # type: ignore[assignment]  # like np.ndarray

  def __repr__(self):
    return f"{type(self).__name__}[{self.expr_id}]"


def ensure_recursion_budget(expr: "Expr") -> None:
  """Size the Python recursion limit to the DAG before the recursive
  rewriters and emitters walk it (one frame per node)."""
  import sys
  n = [0]
  expr.visit(lambda _: n.__setitem__(0, n[0] + 1))
  budget = 10 * n[0] + 1000
  if sys.getrecursionlimit() < budget:
    sys.setrecursionlimit(min(budget, 1_000_000))


class EmitCtx:
  """Context threaded through region emission.

  ``abstract`` marks shape inference over meta tensors; ``differentiable``
  asks emitters to avoid hand-written kernels (they have no autograd
  rule); ``device`` is where creation ops allocate."""

  def __init__(self, abstract: bool = False, differentiable: bool = False,
               device: Optional[torch.device] = None):
    self.abstract = abstract
    self.differentiable = differentiable
    self.device = device


class Val(Expr):
  """Leaf wrapping a materialized value (SpartanArray / ndarray / tensor /
  Python scalar)."""

  _members = ()
  _params = ("value",)

  def __init__(self, value):
    super().__init__(value=value)

  def _emit(self, ctx, deps):
    if ctx.abstract:
      return self.aval().abstract_value()
    return self.leaf_value()

  def aval(self) -> Aval:
    if self._aval is None:
      v = self.value
      if type(v) in _PY_SCALAR_DTYPES:
        # exact Python scalars stay WEAK; numpy scalar types (np.float64
        # subclasses float) are strong under NEP 50 and go below
        self._aval = Aval((), _PY_SCALAR_DTYPES[type(v)], weak=True)
      elif isinstance(v, (SpartanArray, torch.Tensor)):
        self._aval = Aval(v.shape, v.dtype)
      else:
        arr = np.asarray(v)
        self._aval = Aval(arr.shape, to_torch_dtype(arr.dtype))
    return self._aval

  def leaf_value(self):
    """The value a region binds: the device tensor, or the raw Python
    scalar (so it keeps its weak type)."""
    v = self.value
    if isinstance(v, SpartanArray):
      return v.data
    if type(v) in _PY_SCALAR_DTYPES:
      return v
    from spartan_tpu_torch.core.mesh import get_mesh
    device = get_mesh().device
    if isinstance(v, torch.Tensor):
      return v.to(device)
    arr = np.array(v, order="C")
    to_torch_dtype(arr.dtype)
    return torch.from_numpy(arr).to(device)

  def _sig_local(self, memo, result):
    a = self.aval()
    # the leaf ordinal distinguishes aliasing structure: dot(r, r) must not
    # share a runner with dot(p, q)
    ordinal = memo.get("__leaf_counter__", 0)
    memo["__leaf_counter__"] = ordinal + 1
    return ("Val", ordinal) + a.key

  def _sig_store(self, memo, sig):
    memo[self.expr_id] = sig


class ListExpr(Expr):
  """A list of sub-expressions evaluated together (one region, several
  outputs)."""

  _members = ("vals",)
  _params = ()

  def __init__(self, vals):
    super().__init__(vals=[lazify(v) for v in vals])

  def _emit(self, ctx, deps):
    return tuple(deps)

  def aval(self):
    return tuple(v.aval() for v in self.vals)

  def __iter__(self):
    return iter(self.vals)

  def __len__(self):
    return len(self.vals)


def lazify(v: Any) -> Expr:
  """Wrap a concrete value as a leaf expr (reference ``lazify``)."""
  if isinstance(v, Expr):
    return v
  return Val(v)


def evaluate(expr: Any):
  """Evaluate an expr (or container of exprs) to SpartanArray(s)."""
  if isinstance(expr, Expr):
    return expr.evaluate()
  if isinstance(expr, (list, tuple)):
    return type(expr)(evaluate(e) for e in expr)
  if isinstance(expr, dict):
    return {k: evaluate(v) for k, v in expr.items()}
  return expr


force = evaluate


def glom(expr: Any) -> np.ndarray:
  return lazify(expr).glom()
