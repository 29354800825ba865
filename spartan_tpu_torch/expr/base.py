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


class NotShapeable(Exception):
  """A node whose output shape depends on its data (a boolean mask, a host
  op): its abstract value cannot be inferred, so the evaluator evaluates
  it eagerly before the region that reads it."""

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

  def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
    """Keep ``np.add(ndarray, expr)`` and ``np.sqrt(expr)`` lazy: a plain
    call of a ufunc the builtins name goes to that builtin; any other
    ufunc or method materializes its expr operands and runs in NumPy."""
    if method == "__call__" and not kwargs:
      from spartan_tpu_torch.expr import builtins as B
      fn = getattr(B, ufunc.__name__, None)
      if fn is not None and callable(fn):
        return fn(*inputs)
    mat = [np.asarray(x) if isinstance(x, Expr) else x for x in inputs]
    return getattr(ufunc, method)(*mat, **kwargs)

  def item(self):
    return np.asarray(self.glom()).item()

  def tolist(self):
    """The value as nested Python lists (evaluates)."""
    return np.asarray(self.glom()).tolist()

  def __bool__(self):
    # NumPy's rule: a size-1 array converts (this evaluates it), a larger
    # one is ambiguous
    if self.size != 1:
      raise ValueError(
          "The truth value of an array with more than one element is "
          "ambiguous. Use sp.any()/sp.all() (this also forces evaluation "
          "of the lazy expr).")
    return bool(np.asarray(self.glom()).reshape(()))

  def __float__(self):
    if self.size != 1:
      raise TypeError("only size-1 exprs convert to float")
    return float(np.asarray(self.glom()).reshape(()))

  def __int__(self):
    if self.size != 1:
      raise TypeError("only size-1 exprs convert to int")
    return int(np.asarray(self.glom()).reshape(()))

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

  def prod(self, axis=None, keepdims=False) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.prod(self, axis=axis, keepdims=keepdims)

  def std(self, axis=None, ddof=0) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.std(self, axis=axis, ddof=ddof)

  def var(self, axis=None, ddof=0) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.var(self, axis=axis, ddof=ddof)

  def all(self, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.all(self, axis=axis)

  def any(self, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.any(self, axis=axis)

  def clip(self, a_min=None, a_max=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.clip(self, a_min, a_max)

  def round(self, decimals=0) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.round(self, decimals=decimals)

  def conj(self) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.conj(self)

  conjugate = conj

  def copy(self) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.copy(self)

  def squeeze(self, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.squeeze(self, axis=axis)

  def swapaxes(self, a, b) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.swapaxes(self, a, b)

  def repeat(self, repeats, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.repeat(self, repeats, axis=axis)

  def take(self, indices, axis=None) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.take(self, indices, axis=axis)

  def diagonal(self, offset=0) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.diagonal(self, offset=offset)

  def trace(self, offset=0) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.trace(self, offset=offset)

  def outer(self, other) -> "Expr":
    from spartan_tpu_torch.expr import builtins as B
    return B.outer(self, other)

  @property
  def at(self) -> "_AtIndexer":
    """Functional updates as in JAX: ``e.at[idx].set/add/multiply/max/
    min(v)`` is a new lazy expr (``expr/write.py``); ``e`` is unchanged."""
    return _AtIndexer(self)

  def __getitem__(self, idx) -> "Expr":
    from spartan_tpu_torch.expr.slice import make_slice
    return make_slice(self, idx)

  def __setitem__(self, idx, value):
    raise TypeError(
        "exprs are immutable; use the functional update instead:\n"
        "  new = arr.at[idx].set(value)                     # jax-style\n"
        "  new = arr.at[idx].add(value)                     # merge\n"
        "  new = spartan_tpu_torch.write(arr, idx, value, np.add) "
        "# region form")

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
  def __lt__(self, o): return self._binop(o, "less")
  def __le__(self, o): return self._binop(o, "less_equal")
  def __gt__(self, o): return self._binop(o, "greater")
  def __ge__(self, o): return self._binop(o, "greater_equal")
  # elementwise, as in NumPy: the port's bookkeeping compares exprs by
  # expr_id or identity, never with ==
  def __eq__(self, o): return self._binop(o, "equal")  # type: ignore
  def __ne__(self, o): return self._binop(o, "not_equal")  # type: ignore
  def __floordiv__(self, o): return self._binop(o, "floor_divide")
  def __rfloordiv__(self, o): return self._binop(o, "floor_divide", True)
  def __mod__(self, o): return self._binop(o, "remainder")
  def __rmod__(self, o): return self._binop(o, "remainder", True)
  def __and__(self, o): return self._binop(o, "bitwise_and")
  def __rand__(self, o): return self._binop(o, "bitwise_and", True)
  def __or__(self, o): return self._binop(o, "bitwise_or")
  def __ror__(self, o): return self._binop(o, "bitwise_or", True)
  def __xor__(self, o): return self._binop(o, "bitwise_xor")
  def __rxor__(self, o): return self._binop(o, "bitwise_xor", True)
  def __lshift__(self, o): return self._binop(o, "left_shift")
  def __rlshift__(self, o): return self._binop(o, "left_shift", True)
  def __rshift__(self, o): return self._binop(o, "right_shift")
  def __rrshift__(self, o): return self._binop(o, "right_shift", True)
  def __invert__(self): return self._unop("bitwise_not")
  def __neg__(self): return self._unop("negative")
  def __abs__(self): return self._unop("absolute")
  def __pos__(self): return self

  def __pow__(self, o):
    from spartan_tpu_torch.expr import map as map_mod
    return map_mod.power_operator(self, o)

  def __rpow__(self, o):
    from spartan_tpu_torch.expr import map as map_mod
    map_mod.check_power(o, self)
    return self._binop(o, "power", True)

  def __matmul__(self, o):
    return self.dot(o)

  def __rmatmul__(self, o):
    from spartan_tpu_torch.expr import builtins as B
    return B.dot(o, self)

  __hash__ = None  # type: ignore[assignment]  # like np.ndarray

  def __repr__(self):
    try:
      sd = f"shape={self.shape}, dtype={self.dtype}"
    except NotShapeable:
      sd = "shape=<data-dependent>"
    return f"{type(self).__name__}[{self.expr_id}]({sd})"


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


def _same_kind_cast(src: torch.dtype, dst: torch.dtype) -> bool:
  """NumPy's ``can_cast(src, dst, "same_kind")`` (bfloat16 as a float)."""
  from spartan_tpu_torch.core.array import to_numpy_dtype

  def np_dt(d):
    return np.dtype(np.float32) if d == torch.bfloat16 else to_numpy_dtype(d)
  return bool(np.can_cast(np_dt(src), np_dt(dst), casting="same_kind"))


class _AtIndexer:
  """``expr.at[idx]``: an update handle (JAX's ``.at``, lazy)."""

  __slots__ = ("_e",)

  def __init__(self, e: Expr):
    self._e = e

  def __getitem__(self, idx) -> "_AtRef":
    return _AtRef(self._e, idx)


class _AtRef:
  """``expr.at[idx]`` with its index: ``set``, ``add``, ``multiply``,
  ``max`` and ``min`` each give a new expr (``expr/write.py``).

  A concrete index (a Python int, a host array or list) out of bounds
  raises ``IndexError`` when the update is built, as NumPy does; an index
  array that is an expr is data, and its out-of-bounds updates are
  dropped, as the reference's scatter drops them."""

  __slots__ = ("_e", "_idx")

  def __init__(self, e: Expr, idx):
    self._e, self._idx = e, idx

  @staticmethod
  def _is_bool_index(i) -> bool:
    if isinstance(i, Expr):
      return i.dtype == torch.bool
    if isinstance(i, np.ndarray):
      return i.dtype == np.bool_
    if isinstance(i, list):
      try:
        arr = np.asarray(i)
      except ValueError:
        return False
      return arr.size > 0 and arr.dtype == np.bool_
    return False

  def _bool_mask_update(self, mask, v, reducer):
    """``e.at[mask].<op>(v)`` as a ``where`` over the mask, for a size-1
    ``v`` only: NumPy's compressed assignment (``len(v) == mask.sum()``)
    has a shape that depends on the data."""
    from spartan_tpu_torch.expr import builtins as B
    dst = self._e
    mask = lazify(mask)
    if mask.ndim > dst.ndim:
      raise IndexError(
          f".at boolean mask has {mask.ndim} dims; array has {dst.ndim}")
    if tuple(mask.shape) != tuple(dst.shape[:mask.ndim]):
      raise IndexError(
          f".at boolean mask shape {tuple(mask.shape)} does not match "
          f"array leading dims {tuple(dst.shape[:mask.ndim])}")
    if mask.ndim < dst.ndim:  # the mask consumes the leading axes
      mask = B.reshape(mask, tuple(mask.shape) + (1,) * (dst.ndim - mask.ndim))
    v = lazify(v)
    if int(np.prod(v.shape)) != 1:
      raise NotImplementedError(
          ".at[bool_mask] supports scalar values only: numpy's compressed "
          "per-cell assignment (len(v) == mask.sum()) has a data-dependent "
          "shape; use integer indices (np.nonzero(mask)) for per-cell "
          "scatters")
    dt = dst.dtype
    ops = {"set": lambda d, s: s, "add": lambda d, s: d + s,
           "mul": lambda d, s: d * s, "max": B.maximum, "min": B.minimum}
    from spartan_tpu_torch.core.array import canonical_reducer
    return B.where(mask, ops[canonical_reducer(reducer)](dst, v), dst
                   ).astype(dt)

  def _go(self, v, reducer):
    from spartan_tpu_torch.expr import builtins as B
    from spartan_tpu_torch.expr import write as W
    idx = self._idx
    if reducer is not None:
      # the reference's rule, NumPy's same_kind casting: an int array takes
      # no float update
      dt, vt = self._e.dtype, lazify(v).dtype
      from spartan_tpu_torch.expr.map import result_type
      res = result_type(dt, vt)
      if not _same_kind_cast(res, dt):
        name = getattr(reducer, "__name__", reducer)
        raise TypeError(f".at[...].{name}: cannot cast {res} result to {dt} "
                        f"with casting rule 'same_kind'")
    if isinstance(idx, (Expr, np.ndarray, list)):
      if self._is_bool_index(idx):
        return self._bool_mask_update(idx, v, reducer)
      if isinstance(idx, (np.ndarray, list)):
        ia = np.asarray(idx)
        if not self._e.ndim:
          raise IndexError(".at index on a 0-d array")
        n0 = self._e.shape[0]
        if ia.size and (int(ia.min()) < -n0 or int(ia.max()) >= n0):
          raise IndexError(
              f".at index array has entries outside [-{n0}, {n0}) for "
              f"axis 0 with size {n0}")
        idx = ia % n0 if ia.size else ia
      # an index array is data (a child leaf), never a parameter
      return W.ScatterAssignExpr(self._e, idx, v, reducer)
    if isinstance(idx, tuple) and any(
        isinstance(i, (Expr, np.ndarray, list)) for i in idx):
      # e.at[rows, cols]: the k leading axes linearized, so the index
      # arrays stay data and one flat scatter takes them
      if not all(isinstance(i, (Expr, np.ndarray, list, int, np.integer))
                 for i in idx):
        raise NotImplementedError(
            "mixed slice/array advanced .at indexing is not supported: "
            "use sp.write for region updates or flat indices for scatter")
      if any(self._is_bool_index(i) for i in idx):
        raise NotImplementedError(
            "boolean masks inside multi-axis .at indexing are not "
            "supported: use a single full-shape mask or integer indices")
      shape = tuple(self._e.shape)
      k = len(idx)
      if k > self._e.ndim:
        raise IndexError(
            f".at received {k} indices for a {self._e.ndim}-d array")
      lead, trail = shape[:k], shape[k:]
      strides = np.cumprod((1,) + lead[:0:-1])[::-1]
      flat = None
      for d, i in enumerate(idx):
        # concrete indices are checked, then normalized per axis; an expr
        # index wraps like mod (an out-of-bounds one lands elsewhere, as
        # in the reference)
        if isinstance(i, (int, np.integer)):
          if not -lead[d] <= int(i) < lead[d]:
            raise IndexError(
                f".at index {int(i)} is out of bounds for axis {d} with "
                f"size {lead[d]}")
          norm = lazify(int(i) % lead[d])
        elif isinstance(i, (np.ndarray, list)):
          ia = np.asarray(i)
          if ia.size and (int(ia.min()) < -lead[d]
                          or int(ia.max()) >= lead[d]):
            raise IndexError(
                f".at index array for axis {d} has entries outside "
                f"[-{lead[d]}, {lead[d]})")
          norm = lazify(ia % lead[d])
        else:
          norm = lazify(i) % lead[d]
        flat = norm * int(strides[d]) if flat is None else (
            flat + norm * int(strides[d]))
      dst = (B.ravel(self._e) if not trail
             else B.reshape(self._e, (int(np.prod(lead)),) + trail))
      out = W.ScatterAssignExpr(dst, flat, v, reducer)
      return B.reshape(out, shape)
    return W.WriteArrayExpr(self._e, idx, v, reducer)

  def set(self, v) -> Expr:
    return self._go(v, None)

  def add(self, v) -> Expr:
    return self._go(v, np.add)

  def multiply(self, v) -> Expr:
    return self._go(v, np.multiply)

  mul = multiply

  def max(self, v) -> Expr:
    return self._go(v, np.maximum)

  def min(self, v) -> Expr:
    return self._go(v, np.minimum)


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
