"""3×3 stencil kernels K4, K6a and K6b, with their plain torch versions.

:func:`stencil3x3` replaces ``spartan_tpu/backend/kernels/stencil_pallas.py``
``stencil3x3`` (K4: a 'SAME' zero-boundary 3×3 correlation of an (n, m)
array), :func:`stencil3x3_padded` its ``stencil3x3_padded`` (K6a:
``steps`` applications over padded storage, with an optional constant add
field; given ``top``/``bot`` halo rows, one application of K6b), and
:func:`stencil3x3_padded_sharded` its ``stencil3x3_padded_sharded`` (the
field cut into one row band a shard of the mesh, halo rows exchanged by
:func:`_halo_pair` before each sweep, one K6b launch a shard a sweep).
Kernels: ``csrc/stencil3x3.cu`` and ``csrc/stencil3x3_padded.cu`` over the
shared ``csrc/stencil3x3.cuh``.

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
``(new_state, new_buf)``.  A halo row is one row of the padded width (the
reference's (8, C) blocks are the TPU's sublane tile); row -1 of the
interior reads ``top`` and row n reads ``bot``, in their place in the tap
order, so that a sharded sweep equals K6a's over the whole field bit for
bit.  The sharded form needs ``n % p == 0`` (the reference's even bands);
the reference's further factors 8 and 128 are the TPU's tile and are not
asked for.

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

counts = {"k4_launches": 0, "k6a_launches": 0, "k6b_launches": 0,
          "plain_runs": 0, "routed_plain": 0}


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
  build.check_operands("stencil.stencil3x3", x)
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


# -- K6a and K6b -------------------------------------------------------------------

def stencil3x3_padded_plain(xp: torch.Tensor, buf: torch.Tensor,
                            coeffs: Sequence[float], steps: int = 1,
                            add: Optional[torch.Tensor] = None,
                            top: Optional[torch.Tensor] = None,
                            bot: Optional[torch.Tensor] = None):
  n, m = xp.shape[0] - 2 * PAD_R, xp.shape[1] - 2 * PAD_C
  inner = (slice(PAD_R, PAD_R + n), slice(PAD_C, PAD_C + m))
  taps = _taps(_coeffs(coeffs))
  for _ in range(steps):
    # rows -1 .. n of the interior: the ring's, or the halo rows
    rows = xp[PAD_R - 1:PAD_R + n + 1]
    if top is not None:
      rows = torch.cat([top[None], xp[PAD_R:PAD_R + n], bot[None]])
    acc = (add[inner] if add is not None
           else torch.zeros((n, m), dtype=xp.dtype, device=xp.device))
    for di, dj, c in taps:
      acc = acc + c * rows[di:di + n, PAD_C - 1 + dj:PAD_C - 1 + dj + m]
    buf[inner] = acc
    xp, buf = buf, xp
  return xp, buf


def stencil3x3_padded(xp: torch.Tensor, buf: torch.Tensor,
                      coeffs: Sequence[float], steps: int = 1,
                      add: Optional[torch.Tensor] = None,
                      top: Optional[torch.Tensor] = None,
                      bot: Optional[torch.Tensor] = None):
  """``steps`` applications of a zero-boundary 3×3 stencil over padded
  state ``xp``, each into the interior of the other buffer; ``buf`` is a
  second buffer with a zero ring (its interior is overwritten).  ``add``,
  in the same layout, is added to every application.  ``top`` and ``bot``
  (both or neither; rows of ``xp.shape[1]`` values) stand for the rows
  above and below the interior, for one application (``steps`` must be 1).
  Returns ``(new_state, new_buf)``, both padded, to pass straight back in.
  CUDA tensors launch K6a (K6b with halo rows) once per application, CPU
  tensors run :func:`stencil3x3_padded_plain`."""
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
  halos = [t for t in (top, bot) if t is not None]
  if halos:
    if len(halos) != 2 or steps != 1:
      raise ValueError("top and bot come together, for one application "
                       "(steps=1)")
    for t in halos:
      if t.shape != (xp.shape[1],) or t.dtype != xp.dtype:
        raise ValueError(f"a halo row has shape ({xp.shape[1]},) and dtype "
                         f"{xp.dtype}, got {tuple(t.shape)} {t.dtype}")
    if buf.data_ptr() in {t.data_ptr() for t in halos}:
      raise ValueError("a halo row may not be buf, which is written")
  _check_float(xp)
  build.check_operands("stencil.stencil3x3_padded", *operands, *halos)
  if _plain_route(xp):
    return stencil3x3_padded_plain(xp, buf, cs, steps, add, top, bot)
  if not all(t.is_contiguous() for t in operands + halos):
    raise ValueError("stencil3x3_padded's kernel takes contiguous arrays")
  n, m = xp.shape[0] - 2 * PAD_R, xp.shape[1] - 2 * PAD_C
  args = _kernel_args(xp, cs)
  add_ptr = add.data_ptr() if add is not None else None
  halo_ptrs = [t.data_ptr() for t in halos] or [None, None]
  key = "k6b_launches" if halos else "k6a_launches"
  for _ in range(steps):
    build.launch("stencil3x3_padded", xp.device, xp.data_ptr(), add_ptr,
                 *halo_ptrs, buf.data_ptr(), n, m, *args)
    counts[key] += 1
    xp, buf = buf, xp
  return xp, buf


def _halo_pair(bands: Sequence[torch.Tensor]):
  """``(tops, bots)``: for each padded band, copies of the row above its
  interior (the last interior row of the band before it) and of the row
  below (the first of the band after), zeros at the global edge, as the
  reference's ``ppermute`` gives.  The copies run on the bands' device;
  a mesh over several cards would swap only this transport."""
  p = len(bands)
  last = [b[b.shape[0] - PAD_R - 1] for b in bands]
  first = [b[PAD_R] for b in bands]
  tops = [torch.zeros_like(first[0])] + [last[d - 1].clone()
                                         for d in range(1, p)]
  bots = [first[d + 1].clone() for d in range(p - 1)] + [
      torch.zeros_like(first[0])]
  return tops, bots


def stencil3x3_padded_sharded(x: torch.Tensor, coeffs: Sequence[float],
                              steps: int = 1, mesh=None,
                              add: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
  """``steps`` applications of the zero-boundary 3×3 stencil to the
  (n, m) field ``x`` (a tensor, or host data put on the mesh's device),
  row-band sharded over the mesh's p shards: shard d
  keeps its own padded band ``(n/p + 16, m + 256)`` and a second buffer
  (separate tensors), and each sweep exchanges the halo rows
  (:func:`_halo_pair`) and launches K6b once a shard.  ``add`` (n, m) is
  added every sweep.  Returns the (n, m) field.  One shard is K6a over
  the whole field.  Needs ``n % p == 0``."""
  from spartan_tpu_torch.core.mesh import get_mesh
  mesh = mesh or get_mesh()
  p = mesh.size
  cs = _coeffs(coeffs)
  x, add = (None if v is None else torch.as_tensor(v, device=mesh.device)
            for v in (x, add))
  build.check_operands("stencil.stencil3x3_padded_sharded",
                       *[t for t in (x, add) if t is not None])
  if x.dim() != 2 or (add is not None and add.shape != x.shape):
    raise ValueError(f"stencil3x3_padded_sharded takes (n, m) fields, got "
                     f"{tuple(x.shape)}"
                     + (f" and {tuple(add.shape)}" if add is not None else ""))
  n, m = x.shape
  if p == 1:
    xp = to_padded(x)
    out, _ = stencil3x3_padded(xp, torch.zeros_like(xp), cs, steps,
                               None if add is None else to_padded(add))
    return from_padded(out)
  if n % p:
    raise ValueError(f"the sharded padded stencil needs n % {p} == 0 (one "
                     f"even row band a shard); got {(n, m)}")
  bands, bufs, fields = _padded_bands(x, p, add)
  for _ in range(int(steps)):
    _sharded_sweep(bands, bufs, cs, fields)
  return torch.cat([from_padded(b) for b in bands])


def _padded_bands(x: torch.Tensor, p: int, add: Optional[torch.Tensor]):
  """``(bands, bufs, fields)``: for each of p even row bands of ``x`` its
  padded state, a second buffer and its padded ``add`` band (or None), each
  a tensor of its own."""
  nb = x.shape[0] // p
  bands = [to_padded(x[d * nb:(d + 1) * nb]) for d in range(p)]
  bufs = [torch.zeros_like(b) for b in bands]
  fields = ([None] * p if add is None else
            [to_padded(add[d * nb:(d + 1) * nb]) for d in range(p)])
  return bands, bufs, fields


def _sharded_sweep(bands, bufs, coeffs, fields) -> None:
  """One sweep of the sharded stencil: the halo exchange, then one K6b
  application a band; the lists are updated in place (state and buffer
  ping-pong)."""
  tops, bots = _halo_pair(bands)
  for d in range(len(bands)):
    bands[d], bufs[d] = stencil3x3_padded(bands[d], bufs[d], coeffs, 1,
                                          fields[d], tops[d], bots[d])
