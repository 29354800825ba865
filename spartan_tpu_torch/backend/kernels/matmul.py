"""Dense matrix product with a fused epilogue (K2) and its plain version.

:func:`matmul` replaces ``spartan_tpu/backend/kernels/matmul.py:matmul``
(K2, the blocked Pallas MXU kernel): ``epilogue(x @ y)`` for x (M, K) and
y (K, N) with a float32 accumulator, the epilogue applied to the float32
result and the output in ``x.dtype`` (``matmul.py:36-41,78``).  Kernel:
``csrc/matmul.cu``: for bfloat16 and float16 a persistent, warp-specialised
kernel of ``TILE_M`` x ``TILE_N`` output tiles and ``TILE_K``-deep stages,
its operands brought by TMA into a ring in shared memory and multiplied by
``wgmma``; for float32 the same ring of TMA-fed stages
(``SGEMM_TILE_K`` deep) under ``SGEMM_TILE_M`` x ``SGEMM_TILE_N`` tiles,
multiplied by FFMA outside the tensor cores.  Any M, N, K.

The reference traces its epilogue callable into the kernel's last K step.
A CUDA kernel cannot take a callable, so :func:`plan_epilogue` traces it
with ``torch.fx`` into K1's op program (``fused_reduce.Program``, the op
table add … power with immediates), which the kernel runs on each
float32 accumulator before the cast and the store.  An epilogue outside
the table (another op, a tensor operand, a graph fx cannot trace) is
decided up front and counted in ``counts["epilogue_unfused"]``: the kernel
then writes the float32 product and the callable runs on it in torch
before the cast.

Routing: a CPU tensor runs :func:`matmul_plain`; a CUDA tensor launches
the kernel.  TMA describes an operand only with a 16-byte aligned base and
a row stride of a multiple of 16 bytes: an operand without both
(:func:`tma_unfit`) is copied first into a zero-padded, aligned buffer
(:func:`pad_operand`, :func:`kernel_operands`, counted in
``counts["padded_operands"]``), which the kernel reads with the operand's
own extents.  When x and y do not share a dtype in {float32, bfloat16,
float16}, both are cast to float32 first and the kernel's float32 result
is cast to ``x.dtype``, the same function :func:`matmul_plain` computes.
``bm``/``bn``/``bk`` are the reference's
VMEM block sizes, accepted for API parity and ignored: the CUDA kernel
picks its own tiles and takes every shape through predicated edges.
"""

from __future__ import annotations

import ctypes
import operator
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.fx
import torch.nn.functional as F

from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels.fused_reduce import (
    _POWERS, DTYPE_CODES, LOADI, LOADX, MAX_IMM, MAX_INSTR, OPS, Program,
    allocate, fold_scalars)
from spartan_tpu_torch.expr.base import fn_key

_IN_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_F32 = DTYPE_CODES[torch.float32]

# The 16-bit kernel's output tile (TILE_M x TILE_N), the K depth of a
# stage and the stages of its ring, and the float32 kernel's;
# csrc/matmul.cu's H_BM, H_BN, H_BK, kStages and F_BM, F_BN, F_BK,
# F_STAGES.
TILE_M, TILE_N, TILE_K, STAGES = 128, 256, 64, 4
SGEMM_TILE_M, SGEMM_TILE_N, SGEMM_TILE_K, SGEMM_STAGES = 128, 256, 32, 3

counts = {"launches": 0, "plain_runs": 0, "epilogue_unfused": 0,
          "padded_operands": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def matmul_plain(x: torch.Tensor, y: torch.Tensor,
                 epilogue: Optional[Callable] = None) -> torch.Tensor:
  """``epilogue(x.float() @ y.float())``, cast to ``x.dtype``."""
  acc = x.float() @ y.float()
  if epilogue is not None:
    acc = epilogue(acc)
  return acc.to(x.dtype)


# -- the epilogue as an op program ----------------------------------------------

# fx call targets → op-table names; relu and the clamps are maximum or
# minimum with an immediate
_FUNCTIONS = {
    operator.add: "add", torch.add: "add", operator.sub: "subtract",
    torch.sub: "subtract", torch.subtract: "subtract",
    operator.mul: "multiply", torch.mul: "multiply",
    torch.multiply: "multiply", operator.truediv: "true_divide",
    torch.div: "true_divide", torch.true_divide: "true_divide",
    operator.neg: "negative", torch.neg: "negative",
    torch.negative: "negative", operator.abs: "absolute", abs: "absolute",
    torch.abs: "absolute", torch.absolute: "absolute",
    torch.square: "square", torch.sqrt: "sqrt", torch.exp: "exp",
    torch.log: "log", torch.maximum: "maximum", torch.minimum: "minimum",
    torch.clamp_min: "maximum", torch.clamp_max: "minimum",
    operator.floordiv: "floor_divide", torch.floor_divide: "floor_divide",
    operator.mod: "remainder", torch.remainder: "remainder",
    operator.pow: "power", torch.pow: "power",
}
_METHODS = {
    "add": "add", "sub": "subtract", "subtract": "subtract",
    "mul": "multiply", "multiply": "multiply", "div": "true_divide",
    "true_divide": "true_divide", "neg": "negative", "negative": "negative",
    "abs": "absolute", "absolute": "absolute", "square": "square",
    "sqrt": "sqrt", "exp": "exp", "log": "log", "maximum": "maximum",
    "minimum": "minimum", "clamp_min": "maximum", "clamp_max": "minimum",
    "floor_divide": "floor_divide", "remainder": "remainder", "pow": "power",
}
_RELUS = (torch.relu, F.relu)
_BINARY = ("add", "subtract", "multiply", "true_divide", "maximum", "minimum",
           "floor_divide", "remainder", "power")


def _trace(epilogue: Callable):
  """The fx graph of ``epilogue``, or None where fx cannot trace it (not a
  Python function, control flow on the traced value, a call that does not
  take a proxy): such an epilogue is outside the table."""
  if not isinstance(epilogue, types.FunctionType):
    return None
  try:
    return torch.fx.symbolic_trace(epilogue).graph
  except (torch.fx.proxy.TraceError, TypeError, RuntimeError):
    return None


def _translate(graph) -> Optional[Program]:
  """The op program of a traced one-argument epilogue over a float32
  tensor, or None when a node is outside the table.  Every op computes in
  float32, as torch computes a float32 tensor with Python scalars."""
  instrs: List[Tuple[int, int, int, int, int]] = []
  imm_sources: List[Tuple[str, Any]] = []
  regs: Dict[Any, int] = {}
  out = None

  def emit(op: int, dt: int, a: int = 0, b: int = 0) -> Optional[int]:
    if len(instrs) >= MAX_INSTR:
      return None
    instrs.append((op, dt, len(instrs), a, b))
    return len(instrs) - 1

  def operand(arg) -> Optional[int]:
    if isinstance(arg, torch.fx.Node):
      return regs.get(arg)
    if type(arg) in (bool, int, float) and len(imm_sources) < MAX_IMM:
      reg = emit(LOADI, 0, len(imm_sources))
      imm_sources.append(("const", float(arg)))
      return reg
    return None

  placeholders = 0
  for node in graph.nodes:
    if node.op == "placeholder":
      placeholders += 1
      regs[node] = emit(LOADX, _F32)
      continue
    if node.op == "output":
      out = node.args[0]
      break
    if node.op == "get_attr":
      return None
    args, kw = list(node.args), dict(node.kwargs)
    if node.op == "call_function" and node.target in _RELUS:
      kw.pop("inplace", None)
      name, args = "maximum", [args[0], 0.0]
    elif node.op == "call_function" and node.target in _FUNCTIONS:
      name = _FUNCTIONS[node.target]
    elif node.op == "call_method" and node.target == "relu":
      name, args = "maximum", [args[0], 0.0]
    elif node.op == "call_method" and node.target in _METHODS:
      name = _METHODS[node.target]
    else:
      return None
    if kw or len(args) != (2 if name in _BINARY else 1):
      return None
    # a constant exponent that torch's scalar fast path takes as another op
    if (name == "power" and type(args[1]) in (int, float)
        and args[1] in _POWERS):
      name, args = _POWERS[args[1]], args[:1]
    deps = [operand(a) for a in args]
    if any(d is None for d in deps) or not any(
        isinstance(a, torch.fx.Node) for a in args):
      return None
    reg = emit(OPS[name], _F32, deps[0], deps[1] if len(deps) == 2 else 0)
    if reg is None:
      return None
    regs[node] = reg
  if placeholders != 1 or not isinstance(out, torch.fx.Node) or (
      out not in regs):
    return None
  return Program(instrs, regs[out], imm_sources, [], torch.float32)


_plans: Dict[Tuple, Optional[Program]] = {}


def _global_numbers(fn: Callable) -> Tuple:
  """The numbers ``fn`` reads from its module's globals, by name: the trace
  bakes them into the program as immediates, so a later value needs a new
  plan.  ``fn_key`` covers the code, defaults and closure cells."""
  code = getattr(fn, "__code__", None)
  scope = getattr(fn, "__globals__", None)
  if code is None or scope is None:
    return ()
  return tuple((name, repr(scope[name])) for name in code.co_names
               if type(scope.get(name)) in (bool, int, float))


def plan_epilogue(epilogue: Callable) -> Optional[Program]:
  """The op program of ``epilogue`` with its registers allocated (cached
  by the callable's structure and the numbers it reads from its globals),
  or None when it is outside K1's op table or needs more than ``N_REGS``
  live values."""
  key = (fn_key(epilogue), _global_numbers(epilogue))
  if key not in _plans:
    if len(_plans) > 1024:
      _plans.clear()
    graph = _trace(epilogue)
    ssa = None if graph is None else _translate(graph)
    _plans[key] = None if ssa is None else allocate(fold_scalars(ssa))
  return _plans[key]


# -- operands TMA cannot describe -------------------------------------------------

def tma_unfit(t: torch.Tensor) -> bool:
  """True when TMA cannot read the contiguous 2-D 16-bit ``t`` in place: a
  base that is not 16-byte aligned, or rows whose length is not a
  multiple of 16 bytes."""
  return t.data_ptr() % 16 != 0 or (t.shape[1] * t.element_size()) % 16 != 0


def pad_operand(t: torch.Tensor) -> torch.Tensor:
  """``t`` copied into a fresh zero-filled buffer whose rows are rounded up
  to a multiple of 16 bytes; ``t`` is its ``[:, :t.shape[1]]``.  The kernel
  reads only that part, so the product is unchanged."""
  per16 = 16 // t.element_size()
  cols = -(-t.shape[1] // per16) * per16
  out = torch.zeros((t.shape[0], cols), dtype=t.dtype, device=t.device)
  out[:, :t.shape[1]] = t
  return out


def kernel_operands(x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """x and y as the kernel reads them (both of one kernel dtype, K > 0):
  contiguous, and each that TMA cannot read (:func:`tma_unfit`) padded
  (:func:`pad_operand`, counted in ``counts["padded_operands"]``)."""
  x, y = x.contiguous(), y.contiguous()
  padded = [tma_unfit(x), tma_unfit(y)]
  counts["padded_operands"] += sum(padded)
  return (pad_operand(x) if padded[0] else x,
          pad_operand(y) if padded[1] else y)


# -- the wrapper ----------------------------------------------------------------

def matmul(x: torch.Tensor, y: torch.Tensor, bm: int = 512, bn: int = 512,
           bk: int = 512, epilogue: Optional[Callable] = None
           ) -> torch.Tensor:
  """``epilogue(x @ y)`` with a float32 accumulator, returned in
  ``x.dtype``.  CUDA tensors launch K2 (or raise), CPU tensors run
  :func:`matmul_plain`; ``bm``/``bn``/``bk`` are ignored (see the module
  note)."""
  if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
    raise ValueError(f"matmul needs x (M, K) and y (K, N), got "
                     f"{tuple(x.shape)} and {tuple(y.shape)}")
  build.one_device(x, y)
  if x.device.type != "cuda":
    counts["plain_runs"] += 1
    return matmul_plain(x, y, epilogue)
  return _launch(x, y, epilogue)


def _launch(x: torch.Tensor, y: torch.Tensor,
            epilogue: Optional[Callable]) -> torch.Tensor:
  """:func:`matmul`'s kernel route: plan the epilogue, ready the operands
  (:func:`kernel_operands`), launch K2 through ``build.launch`` and run an
  unfused epilogue on its float32 product."""
  out_dtype = x.dtype
  if x.dtype != y.dtype or x.dtype not in _IN_CODES:
    x, y = x.float(), y.float()
  program = None if epilogue is None else plan_epilogue(epilogue)
  fused = epilogue is None or program is not None
  if not fused:
    counts["epilogue_unfused"] += 1
  m, k, n = x.shape[0], x.shape[1], y.shape[1]
  out = torch.empty((m, n), dtype=x.dtype if fused else torch.float32,
                    device=x.device)
  if m and n:
    x_c, y_c = kernel_operands(x, y) if k else (x.contiguous(),
                                                y.contiguous())
    prog = program.host_struct(()) if program is not None else None
    build.launch("matmul", x.device, x_c.data_ptr(), x_c.shape[1],
                 y_c.data_ptr(), y_c.shape[1], out.data_ptr(), m, n, k,
                 _IN_CODES[x.dtype], _IN_CODES[out.dtype],
                 ctypes.addressof(prog) if prog is not None else None)
    counts["launches"] += 1
  if not fused:
    out = epilogue(out)
  return out.to(out_dtype)
