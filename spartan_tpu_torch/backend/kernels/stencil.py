"""3×3 stencil kernels K4 and K6a, with their plain torch versions.

:func:`stencil3x3` replaces ``spartan_tpu/backend/kernels/stencil_pallas.py``
``stencil3x3`` (K4: a 'SAME' zero-boundary 3×3 correlation of an (n, m)
array), and :func:`stencil3x3_padded` its ``stencil3x3_padded`` (K6a:
``steps`` applications over padded storage, with an optional constant add
field).  Kernels: ``csrc/stencil3x3.cu`` and ``csrc/stencil3x3_padded.cu``
over the shared ``csrc/stencil3x3.cuh``.

Both compute ``out = (add or 0) + Σ c[k]·x[i+di-1, j+dj-1]`` in the
reference's tap order (row-major over (di, dj)), skipping taps whose
coefficient is 0.0 on every route, with every op rounded to the array's
dtype.  The plain versions write the same sum as torch ops
(``acc = acc + c * x``), so in float32 a kernel equals its plain version bit
for bit.  One build serves every coefficient set: the coefficients reach
the kernel by value.

Padded layout (the reference's): ``padded_shape(n, m) = (n + 16, m + 256)``,
the interior at ``[PAD_R : PAD_R + n, PAD_C : PAD_C + m]``, the ring zero.
The TPU's block picking and its ragged fallbacks are not carried over: the
kernels take any n ≥ 1 and m ≥ 1.  K6a writes the interior of ``buf`` in
place and leaves its ring as it was; ``steps`` applications are a host loop
of launches that ping-pongs ``xp`` and ``buf`` and returns
``(new_state, new_buf)``.  The reference's sharded form (``top``/``bot``
halo operands, K6b) is not here yet.

Routing is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor of float32, bfloat16 or float16 launches the kernel (or
raises), and a CUDA tensor of another float dtype, float64 included, takes
the plain version by that up-front test (``counts["routed_plain"]``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from spartan_tpu_torch.backend.kernels import build

PAD_R, PAD_C = 8, 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

counts = {"k4_launches": 0, "k6a_launches": 0, "plain_runs": 0,
          "routed_plain": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def padded_shape(n: int, m: int) -> Tuple[int, int]:
  return (n + 2 * PAD_R, m + 2 * PAD_C)


def to_padded(x: torch.Tensor) -> torch.Tensor:
  """Lift (n, m) into the padded layout, ring zero (one copy)."""
  return F.pad(x, (PAD_C, PAD_C, PAD_R, PAD_R))


def from_padded(xp: torch.Tensor) -> torch.Tensor:
  """The interior of a padded array, as a view."""
  return xp[PAD_R:xp.shape[0] - PAD_R, PAD_C:xp.shape[1] - PAD_C]


def _coeffs(coeffs: Sequence[float]) -> Tuple[float, ...]:
  cs = tuple(float(c) for c in coeffs)
  if len(cs) != 9:
    raise ValueError(f"a 3x3 stencil takes 9 coefficients (row-major), got "
                     f"{len(cs)}")
  return cs


def _taps(cs):
  """(di, dj, c) of the applied taps, in the reference's order."""
  return [(k // 3, k % 3, c) for k, c in enumerate(cs) if c != 0.0]


def _kernel_args(x: torch.Tensor, cs):
  """(dtype code, nine C floats, mask of the applied taps)."""
  applied = sum(1 << k for k, c in enumerate(cs) if c != 0.0)
  return _KERNEL_DTYPES[x.dtype], (ctypes.c_float * 9)(*cs), applied


def _check_float(*tensors: torch.Tensor) -> None:
  for t in tensors:
    if not t.is_floating_point():
      raise TypeError(f"a 3x3 stencil takes float arrays, not {t.dtype}")


def _plain_route(x: torch.Tensor) -> bool:
  """Count and return whether ``x`` takes the plain version."""
  if x.device.type != "cuda":
    counts["plain_runs"] += 1
    return True
  if x.dtype not in _KERNEL_DTYPES:
    counts["routed_plain"] += 1
    return True
  return False


# -- K4 -------------------------------------------------------------------------

def stencil3x3_plain(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
  n, m = x.shape
  xp = F.pad(x, (1, 1, 1, 1))
  acc = torch.zeros((n, m), dtype=x.dtype, device=x.device)
  for di, dj, c in _taps(_coeffs(coeffs)):
    acc = acc + c * xp[di:di + n, dj:dj + m]
  return acc


def stencil3x3(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
  """'SAME' zero-boundary 3×3 correlation of a 2-D float array with nine
  row-major coefficients.  CUDA tensors launch K4, CPU tensors run
  :func:`stencil3x3_plain`."""
  cs = _coeffs(coeffs)
  if x.dim() != 2:
    raise ValueError(f"stencil3x3 takes an (n, m) array, got shape "
                     f"{tuple(x.shape)}")
  _check_float(x)
  if _plain_route(x):
    return stencil3x3_plain(x, cs)
  n, m = x.shape
  out = torch.empty((n, m), dtype=x.dtype, device=x.device)
  if n == 0 or m == 0:
    return out
  xc = x.contiguous()
  build.launch("stencil3x3", x.device, xc.data_ptr(), out.data_ptr(), n, m,
               *_kernel_args(x, cs))
  counts["k4_launches"] += 1
  return out


# -- K6a ------------------------------------------------------------------------

def stencil3x3_padded_plain(xp: torch.Tensor, buf: torch.Tensor,
                            coeffs: Sequence[float], steps: int = 1,
                            add: Optional[torch.Tensor] = None):
  n, m = xp.shape[0] - 2 * PAD_R, xp.shape[1] - 2 * PAD_C
  inner = (slice(PAD_R, PAD_R + n), slice(PAD_C, PAD_C + m))
  taps = _taps(_coeffs(coeffs))
  for _ in range(steps):
    acc = (add[inner] if add is not None
           else torch.zeros((n, m), dtype=xp.dtype, device=xp.device))
    for di, dj, c in taps:
      acc = acc + c * xp[PAD_R - 1 + di:PAD_R - 1 + di + n,
                         PAD_C - 1 + dj:PAD_C - 1 + dj + m]
    buf[inner] = acc
    xp, buf = buf, xp
  return xp, buf


def stencil3x3_padded(xp: torch.Tensor, buf: torch.Tensor,
                      coeffs: Sequence[float], steps: int = 1,
                      add: Optional[torch.Tensor] = None):
  """``steps`` applications of a zero-boundary 3×3 stencil over padded
  state ``xp``, each into the interior of the other buffer; ``buf`` is a
  second buffer with a zero ring (its interior is overwritten).  ``add``,
  in the same layout, is added to every application.  Returns
  ``(new_state, new_buf)``, both padded, to pass straight back in.  CUDA
  tensors launch K6a once per application, CPU tensors run
  :func:`stencil3x3_padded_plain`."""
  cs = _coeffs(coeffs)
  steps = int(steps)
  operands = [xp, buf] + ([add] if add is not None else [])
  if xp.dim() != 2 or xp.shape[0] <= 2 * PAD_R or xp.shape[1] <= 2 * PAD_C:
    raise ValueError(f"stencil3x3_padded takes a padded (n + {2 * PAD_R}, "
                     f"m + {2 * PAD_C}) array with n, m >= 1, got shape "
                     f"{tuple(xp.shape)}")
  for t in operands[1:]:
    if t.shape != xp.shape or t.dtype != xp.dtype:
      raise ValueError(f"buf and add must match xp's shape {tuple(xp.shape)} "
                       f"and dtype {xp.dtype}, got {tuple(t.shape)} {t.dtype}")
  if len({t.data_ptr() for t in operands}) != len(operands):
    raise ValueError("xp, buf and add must be distinct buffers: buf is "
                     "written while xp and add are read")
  if steps < 0:
    raise ValueError(f"steps must be >= 0, got {steps}")
  _check_float(xp)
  build.one_device(*operands)
  if _plain_route(xp):
    return stencil3x3_padded_plain(xp, buf, cs, steps, add)
  if not all(t.is_contiguous() for t in operands):
    raise ValueError("stencil3x3_padded's kernel takes contiguous arrays")
  n, m = xp.shape[0] - 2 * PAD_R, xp.shape[1] - 2 * PAD_C
  args = _kernel_args(xp, cs)
  add_ptr = add.data_ptr() if add is not None else None
  for _ in range(steps):
    build.launch("stencil3x3_padded", xp.device, xp.data_ptr(), add_ptr,
                 buf.data_ptr(), n, m, *args)
    counts["k6a_launches"] += 1
    xp, buf = buf, xp
  return xp, buf
