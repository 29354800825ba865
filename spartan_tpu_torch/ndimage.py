"""``sp.ndimage`` — the scipy.ndimage surface (port of
``spartan_tpu/ndimage.py``).

Every kernel that is not elementwise is a ``map.structural`` function over
whole torch tensors on the mesh's device:

* **filters** — the boundary is one pad in the NumPy mode ``_PAD_MODE``
  maps the ndimage mode to, then one ``torch.nn.functional.conv1d/2d/3d``
  (TF32 off, ``sp.initialize``) for 1-3 dimensions, a sum of shifted copies
  beyond.  A separable filter (``gaussian_filter``, ``uniform_filter``,
  ``sobel``, ``prewitt``) makes one 1-D pass an axis.
* **rank filters and grey morphology** — the input padded once and sliced
  at each offset of the footprint.  The extremum filters and the binary
  morphology fold the slices into a running minimum, maximum, ``all`` or
  ``any``; ``rank_filter``/``median_filter``/``percentile_filter`` and
  ``vectorized_filter`` stack them, which costs the footprint's size times
  the image, and sort the stack through ``expr.sort_expr`` (a NaN of either
  sign last).
* **the loops** — ``binary_propagation``, ``binary_fill_holes``,
  ``binary_dilation(iterations < 1)``/``binary_erosion(iterations < 1)``
  and ``label`` iterate a monotone step to its fixed point; another round
  after it changes nothing, so the stop test is read on the host once every
  ``CHECK_EVERY`` rounds (``counts``).  ``label`` propagates the least flat
  index of each component with pointer jumping, then numbers the
  components 1..n in raster order of their first pixel on the device (a
  component's root is the pixel whose index it carries; its label is the
  running count of roots).
* **measurements** — segment reductions over the flattened label grid:
  each pixel's slot in the sorted ``index`` by ``searchsorted``, then
  ``index_add_`` (sums and counts, in float64, rounded once to
  ``result_type(input, float32)``) and ``scatter_reduce`` (``amin``,
  ``amax``, first positions).  Nothing grows as labels × pixels.  Without
  labels they are ``sp.sum``/``sp.mean``/``sp.min``/``sp.max``/
  ``sp.argmin``/``sp.argmax``, as the reference's.
* **fourier filters** — the multiplier of scipy's ``fourier_*`` on a ones
  array, computed on the host and applied lazily.
* **interpolation** — ``map_coordinates``/``shift``/``zoom``/``rotate``/
  ``affine_transform`` at order 0 or 1 in ``_JAX_COORD_MODES`` gather and
  blend on the device as ``jax.scipy.ndimage`` does (order 0 rounds half
  away from zero), with scipy's ``cval`` outside ``[0, n - 1]`` in
  ``constant`` mode; the grids of ``shift``/``zoom``/``rotate``/
  ``affine_transform`` are built on the device.
* **host boundaries** — spline orders above 1, the other modes,
  ``geometric_transform``, ``spline_filter*``, the distance transforms,
  ``watershed_ift``, ``find_objects``, ``generic_filter*``, ``median``,
  ``histogram``, ``labeled_comprehension``, ``value_indices`` and
  ``iterate_structure`` call scipy.ndimage on the evaluated inputs, counted
  in ``expr.fio.counts["host_runs"]``.

Where the reference differs from scipy the port follows scipy:
``percentile_filter``'s rank, ``rotate(reshape=True)``'s shape, a NaN in
one label (it stays in that label), and ``labels`` without ``index`` (every
label above 0 as one region).  Integer and bool images filter in float64
(NumPy's ``result_type(dtype, float32)``; scipy keeps the integer dtype and
truncates, the reference gives float32).
"""

from __future__ import annotations

import builtins as _py
import itertools
import math

import numpy as np
import scipy.ndimage as _ndi
import torch
import torch.nn.functional as _F

import spartan_tpu_torch as sp
from spartan_tpu_torch.core.array import to_numpy_dtype
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr import sort_expr as _sort
from spartan_tpu_torch.expr.builtins import _pad_fn
from spartan_tpu_torch.signal import _const
from spartan_tpu_torch.special import _host_value, _mapn_whole

__all__ = [
    # filters
    "correlate", "convolve", "correlate1d", "convolve1d",
    "uniform_filter", "uniform_filter1d", "gaussian_filter",
    "gaussian_filter1d", "gaussian_laplace",
    "gaussian_gradient_magnitude", "laplace", "sobel", "prewitt",
    "generic_laplace", "generic_gradient_magnitude",
    "minimum_filter", "minimum_filter1d", "maximum_filter",
    "maximum_filter1d", "median_filter", "rank_filter",
    "percentile_filter", "vectorized_filter",
    # morphology
    "generate_binary_structure", "iterate_structure",
    "binary_erosion", "binary_dilation", "binary_opening",
    "binary_closing", "binary_propagation", "binary_fill_holes",
    "binary_hit_or_miss", "grey_erosion", "grey_dilation",
    "grey_opening", "grey_closing", "morphological_gradient",
    "morphological_laplace", "white_tophat", "black_tophat",
    # measurements
    "label", "sum", "sum_labels", "mean", "variance",
    "standard_deviation", "minimum", "maximum", "median",
    "minimum_position", "maximum_position", "extrema",
    "center_of_mass", "histogram", "labeled_comprehension",
    "find_objects", "value_indices",
    # fourier
    "fourier_gaussian", "fourier_shift", "fourier_uniform",
    "fourier_ellipsoid",
    # interpolation
    "map_coordinates", "shift", "zoom", "rotate", "affine_transform",
    "geometric_transform", "spline_filter", "spline_filter1d",
    # host boundaries
    "distance_transform_edt", "distance_transform_cdt",
    "distance_transform_bf", "watershed_ift", "generic_filter",
    "generic_filter1d",
]

# the ndimage boundary modes as NumPy pad modes
_PAD_MODE = {
    "reflect": "symmetric", "grid-mirror": "symmetric",
    "mirror": "reflect",
    "nearest": "edge",
    "wrap": "wrap", "grid-wrap": "wrap",
    "constant": "constant", "grid-constant": "constant",
}

# the modes jax.scipy.ndimage.map_coordinates takes (order <= 1 on device)
_JAX_COORD_MODES = {"constant", "nearest", "mirror", "reflect", "wrap"}

CHECK_EVERY = 8  # rounds of a loop between host reads of its stop test

# rounds and host reads of the loops
counts = {"flood_rounds": 0, "label_rounds": 0, "erosion_rounds": 0,
          "reads": 0}

_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}


def _host(name, *args, **kw):
  """scipy.ndimage.<name> on the evaluated inputs, counted."""
  fio.counts["host_runs"] += 1
  return getattr(_ndi, name)(*[_host_value(a) for a in args],
                             **{k: _host_value(v) for k, v in kw.items()})


def _origins(origin, nd):
  o = np.broadcast_to(np.asarray(origin, int), (nd,))
  return tuple(int(v) for v in o)


def _check_origins(shape, origins):
  for s, o in zip(shape, origins):
    if not -(s // 2) <= o <= (s - 1) // 2:
      raise ValueError("invalid origin")


def _float_of(x):
  """NumPy's ``result_type(x.dtype, float32)``: integer and bool images
  become float64, 16-bit floats float32; float32/float64 stay."""
  if x.dtype in (torch.float32, torch.float64) or x.is_complex():
    return x
  if x.dtype in (torch.float16, torch.bfloat16):
    return x.to(torch.float32)
  return x.to(torch.float64)


def _pad_mode_of(mode):
  if mode not in _PAD_MODE:
    raise ValueError(f"unknown boundary mode {mode!r}")
  return _PAD_MODE[mode]


def _pad(x, pads, mode, cval):
  """``x`` padded by ``pads`` ((lo, hi) an axis) in the NumPy mode of the
  ndimage ``mode`` (``cval`` for ``constant``)."""
  jmode = _pad_mode_of(mode)
  pads = tuple((int(lo), int(hi)) for lo, hi in pads)
  if not _py.any(lo or hi for lo, hi in pads):
    return x
  kw = {"constant_values": cval} if jmode == "constant" else {}
  return _pad_fn(x, pads, jmode, kw)


def _weights(weights):
  return np.asarray(_host_value(sp.lazify(weights)), dtype=float)


# ---------------------------------------------------------------------
# correlation and convolution (one pad, then conv1d/2d/3d)
# ---------------------------------------------------------------------

def _xcorr_valid(xp, w):
  """The valid cross-correlation of the padded ``xp`` with ``w``."""
  if xp.is_complex():
    return torch.complex(_xcorr_valid(xp.real, w), _xcorr_valid(xp.imag, w))
  if xp.ndim in _CONV:
    return _CONV[xp.ndim](xp[None, None], w[None, None])[0, 0]
  out_shape = [n - s + 1 for n, s in zip(xp.shape, w.shape)]
  out = torch.zeros(out_shape, dtype=xp.dtype, device=xp.device)
  wh = w.detach().cpu().numpy() if not w.is_meta else np.ones(w.shape)
  for off in np.argwhere(wh != 0):
    sl = tuple(slice(int(o), int(o) + n) for o, n in zip(off, out_shape))
    out = out + w[tuple(int(o) for o in off)] * xp[sl]
  return out


def _corr_kernel(w, mode, cval, orig):
  pads = [(s // 2 + o, s - 1 - (s // 2 + o)) for s, o in zip(w.shape, orig)]

  def kern(xx):
    x = _float_of(xx)
    wt = _const(w, x, x.real.dtype)
    return _xcorr_valid(_pad(x, pads, mode, cval), wt)
  return kern


def _corr_nd(input, weights, mode, cval, origin, flip: bool):
  X = sp.lazify(input)
  w = _weights(weights)
  nd = len(X.shape)
  if w.ndim != nd:
    raise RuntimeError("filter weights array has incorrect shape.")
  orig = _origins(origin, nd)
  _check_origins(w.shape, orig)
  if flip:
    w = w[tuple(slice(None, None, -1) for _ in range(nd))]
    orig = tuple(-o - (1 - s % 2) for o, s in zip(orig, w.shape))
  _pad_mode_of(mode)
  return _mapn_whole(_corr_kernel(w, mode, cval, orig), X)


def correlate(input, weights, output=None, mode: str = "reflect",
              cval: float = 0.0, origin=0):
  """N-D correlation: one boundary pad, then ``conv1d/2d/3d``."""
  del output
  return _corr_nd(input, weights, mode, cval, origin, flip=False)


def convolve(input, weights, output=None, mode: str = "reflect",
             cval: float = 0.0, origin=0):
  """N-D convolution: the correlation with the flipped weights."""
  del output
  return _corr_nd(input, weights, mode, cval, origin, flip=True)


def _corr1d(input, weights, axis, mode, cval, origin, flip: bool):
  X = sp.lazify(input)
  nd = len(X.shape)
  w = np.atleast_1d(_weights(weights))
  shape = [1] * nd
  shape[axis % nd] = w.size
  o = [0] * nd
  o[axis % nd] = int(origin)
  return _corr_nd(X, w.reshape(shape), mode, cval, tuple(o), flip)


def correlate1d(input, weights, axis: int = -1, output=None,
                mode: str = "reflect", cval: float = 0.0, origin=0):
  del output
  return _corr1d(input, weights, axis, mode, cval, origin, False)


def convolve1d(input, weights, axis: int = -1, output=None,
               mode: str = "reflect", cval: float = 0.0, origin=0):
  del output
  return _corr1d(input, weights, axis, mode, cval, origin, True)


def uniform_filter1d(input, size: int, axis: int = -1, output=None,
                     mode: str = "reflect", cval: float = 0.0,
                     origin=0):
  del output
  return _corr1d(input, np.full(int(size), 1.0 / int(size)), axis,
                 mode, cval, origin, False)


def _axes_of(nd, axes):
  return tuple(range(nd)) if axes is None else tuple(a % nd for a in axes)


def uniform_filter(input, size=3, output=None, mode: str = "reflect",
                   cval: float = 0.0, origin=0, *, axes=None):
  """Separable box filter: one 1-D pass an axis."""
  del output
  X = sp.lazify(input)
  axes = _axes_of(len(X.shape), axes)
  sizes = np.broadcast_to(np.asarray(size, int), (len(axes),))
  origins = np.broadcast_to(np.asarray(origin, int), (len(axes),))
  out = X
  for ax, s, o in zip(axes, sizes, origins):
    out = uniform_filter1d(out, int(s), axis=ax, mode=mode, cval=cval,
                           origin=int(o))
  return out


def _gauss_kernel(sigma: float, order: int, truncate: float, radius):
  """scipy's ``_gaussian_kernel1d``: the normalized Gaussian, with the
  Hermite-polynomial factor of its ``order``-th derivative."""
  r = int(radius) if radius is not None else int(truncate * float(sigma)
                                                 + 0.5)
  xk = np.arange(-r, r + 1, dtype=float)
  phi = np.exp(-0.5 * xk * xk / (sigma * sigma))
  phi /= phi.sum()
  if order == 0:
    return phi
  q = np.zeros(order + 1)
  q[0] = 1
  D = np.diag(np.arange(1, order + 1), 1)             # d/dx
  P = np.diag(np.ones(order) / -(sigma * sigma), -1)  # x * -1/sigma^2
  Q_deriv = D + P
  for _ in range(order):
    q = Q_deriv.dot(q)
  q = (xk[:, None] ** np.arange(order + 1)[None]).dot(q)
  return q * phi


def gaussian_filter1d(input, sigma: float, axis: int = -1,
                      order: int = 0, output=None,
                      mode: str = "reflect", cval: float = 0.0,
                      truncate: float = 4.0, *, radius=None):
  """1-D Gaussian (and its derivatives): host weights, one correlation."""
  del output
  w = _gauss_kernel(float(sigma), int(order), truncate, radius)
  return _corr1d(input, w[::-1], axis, mode, cval, 0, False)


def gaussian_filter(input, sigma, order=0, output=None,
                    mode: str = "reflect", cval: float = 0.0,
                    truncate: float = 4.0, *, radius=None, axes=None):
  """Separable N-D Gaussian: one 1-D pass an axis."""
  del output
  X = sp.lazify(input)
  axes = _axes_of(len(X.shape), axes)
  sigmas = np.broadcast_to(np.asarray(sigma, float), (len(axes),))
  orders = np.broadcast_to(np.asarray(order, int), (len(axes),))
  out = X
  for ax, s, o in zip(axes, sigmas, orders):
    if s > 1e-15:
      out = gaussian_filter1d(out, float(s), axis=ax, order=int(o),
                              mode=mode, cval=cval, truncate=truncate,
                              radius=radius)
  return out


def generic_laplace(input, derivative2, output=None,
                    mode: str = "reflect", cval: float = 0.0,
                    extra_arguments=(), extra_keywords=None):
  del output
  X = sp.lazify(input)
  if not X.shape:
    return X  # scipy's: a 0-d input has no axis to differentiate
  kw = extra_keywords or {}
  out = derivative2(X, 0, None, mode, cval, *extra_arguments, **kw)
  for ax in range(1, len(X.shape)):
    out = out + derivative2(X, ax, None, mode, cval, *extra_arguments,
                            **kw)
  return out


def laplace(input, output=None, mode: str = "reflect",
            cval: float = 0.0):
  """N-D Laplace: the sum of second-difference correlations."""
  def d2(x, ax, out, m, cv):
    return correlate1d(x, np.array([1.0, -2.0, 1.0]), ax, out, m, cv, 0)
  return generic_laplace(input, d2, output, mode, cval)


def gaussian_laplace(input, sigma, output=None, mode: str = "reflect",
                     cval: float = 0.0, **kwargs):
  def d2(x, ax, out, m, cv):
    orders = [0] * len(sp.lazify(x).shape)
    orders[ax] = 2
    return gaussian_filter(x, sigma, orders, out, m, cv, **kwargs)
  return generic_laplace(input, d2, output, mode, cval)


def generic_gradient_magnitude(input, derivative, output=None,
                               mode: str = "reflect", cval: float = 0.0,
                               extra_arguments=(), extra_keywords=None):
  del output
  X = sp.lazify(input)
  if not X.shape:
    return X
  kw = extra_keywords or {}
  acc = None
  for ax in range(len(X.shape)):
    d = derivative(X, ax, None, mode, cval, *extra_arguments, **kw)
    acc = d * d if acc is None else acc + d * d
  return sp.sqrt(acc)


def gaussian_gradient_magnitude(input, sigma, output=None,
                                mode: str = "reflect",
                                cval: float = 0.0, **kwargs):
  def d1(x, ax, out, m, cv):
    orders = [0] * len(sp.lazify(x).shape)
    orders[ax] = 1
    return gaussian_filter(x, sigma, orders, out, m, cv, **kwargs)
  return generic_gradient_magnitude(input, d1, output, mode, cval)


def _edge_filter(input, axis, mode, cval, smooth):
  X = sp.lazify(input)
  nd = len(X.shape)
  ax = axis % nd
  out = correlate1d(X, np.array([-1.0, 0.0, 1.0]), ax, None, mode, cval, 0)
  for a in range(nd):
    if a != ax:
      out = correlate1d(out, smooth, a, None, mode, cval, 0)
  return out


def sobel(input, axis: int = -1, output=None, mode: str = "reflect",
          cval: float = 0.0):
  del output
  return _edge_filter(input, axis, mode, cval, np.array([1.0, 2.0, 1.0]))


def prewitt(input, axis: int = -1, output=None, mode: str = "reflect",
            cval: float = 0.0):
  del output
  return _edge_filter(input, axis, mode, cval, np.array([1.0, 1.0, 1.0]))


# ---------------------------------------------------------------------
# rank filters and grey morphology (the footprint's shifted windows)
# ---------------------------------------------------------------------

def _footprint_of(size, footprint, nd, name):
  if footprint is not None:
    fp = np.asarray(_host_value(sp.lazify(footprint))).astype(bool)
    if fp.ndim != nd:
      raise RuntimeError("footprint array has incorrect shape.")
    return fp
  if size is None:
    raise ValueError(f"{name}: either size or footprint must be given")
  sizes = tuple(np.broadcast_to(np.asarray(size, int), (nd,)))
  return np.ones(sizes, bool)


def _fp_offsets(fp, origin, flip: bool):
  """The footprint's cells as offsets from its (origin-shifted) centre."""
  nd = fp.ndim
  orig = _origins(origin, nd)
  _check_origins(fp.shape, orig)
  if flip:
    fp = fp[tuple(slice(None, None, -1) for _ in range(nd))]
    orig = tuple(-o - (1 - s % 2) for o, s in zip(orig, fp.shape))
  centers = [s // 2 + o for s, o in zip(fp.shape, orig)]
  offs = np.argwhere(fp) - np.asarray(centers, int)
  return fp, offs


def _windows(x, offs, mode, cval):
  """The slices of ``x`` padded once at each offset of ``offs`` (a list of
  views, each of ``x``'s shape)."""
  nd = x.ndim
  if len(offs) == 0:
    raise RuntimeError("footprint array has no true elements")
  lo = [max(0, int(-offs[:, d].min())) for d in range(nd)]
  hi = [max(0, int(offs[:, d].max())) for d in range(nd)]
  xp = _pad(x, list(zip(lo, hi)), mode, cval)
  return [xp[tuple(slice(lo[d] + int(off[d]), lo[d] + int(off[d]) + x.shape[d])
                   for d in range(nd))] for off in offs]


def _fold(planes, op):
  """A running ``op`` (``torch.minimum``, ``logical_or``, ...) over the
  planes, never more than two images live."""
  out = planes[0]
  for p in planes[1:]:
    out = op(out, p)
  return out


_MINMAX = {"min": torch.minimum, "max": torch.maximum}


def _rank_kernel(offs, mode, cval, reduce, addv=None):
  """A kernel over the footprint's windows: ``reduce`` is ``"min"`` or
  ``"max"`` (folded plane by plane) or the rank taken from the sorted
  stack; ``addv`` is added to the plane of each offset (grey morphology
  with a structure)."""
  def kern(xx):
    x = _float_of(xx)
    planes = _windows(x, offs, mode, cval)
    if addv is not None:
      planes = [p + float(a) for p, a in zip(planes, addv)]
    if reduce in _MINMAX:
      return _fold(planes, _MINMAX[reduce])
    return _sort.sort(torch.stack(planes, -1), -1)[..., reduce]
  return kern


def _rank_core(input, fp, origin, mode, cval, reduce, flip=False,
               add=None):
  X = sp.lazify(input)
  _pad_mode_of(mode)
  fp2, offs = _fp_offsets(fp, origin, flip)
  addv = None if add is None else (add[fp2] if add.shape == fp2.shape
                                   else add)
  return _mapn_whole(_rank_kernel(offs, mode, cval, reduce, addv), X)


def minimum_filter(input, size=None, footprint=None, output=None,
                   mode: str = "reflect", cval: float = 0.0, origin=0,
                   *, axes=None):
  """The minimum over the footprint (a running minimum of its windows)."""
  del output, axes
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "minimum_filter")
  return _rank_core(X, fp, origin, mode, cval, "min")


def maximum_filter(input, size=None, footprint=None, output=None,
                   mode: str = "reflect", cval: float = 0.0, origin=0,
                   *, axes=None):
  """The maximum over the footprint (a running maximum of its windows)."""
  del output, axes
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "maximum_filter")
  return _rank_core(X, fp, origin, mode, cval, "max")


def _filter1d_footprint(X, size, axis, origin):
  nd = len(X.shape)
  shape = [1] * nd
  shape[axis % nd] = int(size)
  o = [0] * nd
  o[axis % nd] = int(origin)
  return np.ones(shape, bool), tuple(o)


def minimum_filter1d(input, size: int, axis: int = -1, output=None,
                     mode: str = "reflect", cval: float = 0.0,
                     origin=0):
  del output
  X = sp.lazify(input)
  fp, o = _filter1d_footprint(X, size, axis, origin)
  return _rank_core(X, fp, o, mode, cval, "min")


def maximum_filter1d(input, size: int, axis: int = -1, output=None,
                     mode: str = "reflect", cval: float = 0.0,
                     origin=0):
  del output
  X = sp.lazify(input)
  fp, o = _filter1d_footprint(X, size, axis, origin)
  return _rank_core(X, fp, o, mode, cval, "max")


def rank_filter(input, rank: int, size=None, footprint=None,
                output=None, mode: str = "reflect", cval: float = 0.0,
                origin=0, *, axes=None):
  """The ``rank``-th value of each window: the windows stacked (the
  footprint's size times the image) and sorted along the stack."""
  del output, axes
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "rank_filter")
  n = int(fp.sum())
  r = int(rank)
  if r < 0:
    r += n
  if r < 0 or r >= n:
    raise RuntimeError("rank not within filter footprint size")
  return _rank_core(X, fp, origin, mode, cval, r)


def median_filter(input, size=None, footprint=None, output=None,
                  mode: str = "reflect", cval: float = 0.0, origin=0,
                  *, axes=None):
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "median_filter")
  return rank_filter(X, int(fp.sum()) // 2, footprint=fp, output=output,
                     mode=mode, cval=cval, origin=origin, axes=axes)


def percentile_filter(input, percentile: float, size=None,
                      footprint=None, output=None,
                      mode: str = "reflect", cval: float = 0.0,
                      origin=0, *, axes=None):
  """scipy's rank ``int(n p / 100)`` (``n - 1`` at p = 100)."""
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "percentile_filter")
  p = float(percentile)
  if p < 0:
    p += 100.0
  if p < 0 or p > 100:
    raise RuntimeError("invalid percentile")
  n = int(fp.sum())
  rank = n - 1 if p == 100.0 else int(float(n) * p / 100.0)
  return rank_filter(X, rank, footprint=fp, output=output, mode=mode,
                     cval=cval, origin=origin, axes=axes)


def vectorized_filter(input, function, *, size=None, footprint=None,
                      output=None, mode: str = "reflect", cval=0.0,
                      origin=0, axes=None, batch_memory=None):
  """``function(stack, axis=0)`` over the stacked windows (the footprint's
  size times the image): ``function`` takes a torch tensor."""
  del output, axes, batch_memory
  X = sp.lazify(input)
  fp = _footprint_of(size, footprint, len(X.shape), "vectorized_filter")
  _pad_mode_of(mode)
  _, offs = _fp_offsets(fp, origin, False)

  def kern(xx):
    x = _float_of(xx)
    out = function(torch.stack(_windows(x, offs, mode, cval)), axis=0)
    return torch.as_tensor(out, device=x.device)
  return _mapn_whole(kern, X)


# ---------------------------------------------------------------------
# grey morphology
# ---------------------------------------------------------------------

def _grey_structure(size, footprint, structure, nd, name):
  if structure is not None:
    st = np.asarray(_host_value(sp.lazify(structure)), dtype=float)
    fp = (np.ones(st.shape, bool) if footprint is None else
          np.asarray(_host_value(sp.lazify(footprint))).astype(bool))
    return fp, st
  return _footprint_of(size, footprint, nd, name), None


def grey_erosion(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  """The minimum over the footprint of ``x - structure``."""
  del output, axes
  X = sp.lazify(input)
  fp, st = _grey_structure(size, footprint, structure, len(X.shape),
                           "grey_erosion")
  return _rank_core(X, fp, origin, mode, cval, "min",
                    add=None if st is None else -st)


def grey_dilation(input, size=None, footprint=None, structure=None,
                  output=None, mode: str = "reflect", cval: float = 0.0,
                  origin=0, *, axes=None):
  """The maximum over the reflected footprint of ``x + structure``."""
  del output, axes
  X = sp.lazify(input)
  fp, st = _grey_structure(size, footprint, structure, len(X.shape),
                           "grey_dilation")
  add = None if st is None else st[tuple(
      slice(None, None, -1) for _ in range(st.ndim))]
  return _rank_core(X, fp, origin, mode, cval, "max", flip=True, add=add)


def grey_opening(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  e = grey_erosion(input, size, footprint, structure, None, mode, cval,
                   origin)
  return grey_dilation(e, size, footprint, structure, output, mode, cval,
                       origin, axes=axes)


def grey_closing(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  d = grey_dilation(input, size, footprint, structure, None, mode, cval,
                    origin)
  return grey_erosion(d, size, footprint, structure, output, mode, cval,
                      origin, axes=axes)


def morphological_gradient(input, size=None, footprint=None,
                           structure=None, output=None,
                           mode: str = "reflect", cval: float = 0.0,
                           origin=0, *, axes=None):
  del axes
  return (grey_dilation(input, size, footprint, structure, None, mode,
                        cval, origin)
          - grey_erosion(input, size, footprint, structure, output, mode,
                         cval, origin))


def morphological_laplace(input, size=None, footprint=None,
                          structure=None, output=None,
                          mode: str = "reflect", cval: float = 0.0,
                          origin=0, *, axes=None):
  del axes
  X = sp.lazify(input)
  return (grey_dilation(X, size, footprint, structure, None, mode, cval,
                        origin)
          + grey_erosion(X, size, footprint, structure, output, mode, cval,
                         origin) - 2.0 * X)


def white_tophat(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  del axes
  X = sp.lazify(input)
  return X - grey_opening(X, size, footprint, structure, output, mode,
                          cval, origin)


def black_tophat(input, size=None, footprint=None, structure=None,
                 output=None, mode: str = "reflect", cval: float = 0.0,
                 origin=0, *, axes=None):
  del axes
  X = sp.lazify(input)
  return grey_closing(X, size, footprint, structure, output, mode, cval,
                      origin) - X


# ---------------------------------------------------------------------
# binary morphology and the loops
# ---------------------------------------------------------------------

def generate_binary_structure(rank: int, connectivity: int):
  """scipy's structuring element: the cells within ``connectivity`` steps
  of the centre in the 3^rank cube (built on the host, a constant)."""
  if connectivity < 1:
    connectivity = 1
  if rank < 1:
    return np.array(True, dtype=bool)
  return np.add.reduce(np.fabs(np.indices([3] * rank) - 1), 0) \
      <= connectivity


def iterate_structure(structure, iterations: int, origin=None):
  return _host("iterate_structure",
               np.asarray(_host_value(sp.lazify(structure))).astype(bool),
               int(iterations), origin)


def _structure(structure, nd):
  return (generate_binary_structure(nd, 1) if structure is None
          else np.asarray(_host_value(sp.lazify(structure))).astype(bool))


def _window_fold(cur, offs, border, op):
  """``op`` folded over ``cur``'s windows at ``offs``, the border filled
  with ``border``."""
  return _fold(_windows(cur, offs, "constant", border), op)


def _fixed_point(step, state, key):
  """Iterate the monotone ``step`` until it changes nothing: the rounds in
  blocks of ``CHECK_EVERY``, the last two states of a block compared on
  the host (one read a block), counted in ``counts[key]`` and
  ``counts["reads"]``.  On meta tensors (shape inference) no round runs."""
  if state.is_meta:
    return state
  while True:
    for _ in range(CHECK_EVERY):
      prev, state = state, step(state)
      counts[key] += 1
    counts["reads"] += 1
    if torch.equal(prev, state):
      return state


def _binary_kernel(offs, border_value, erosion, iterations, masked):
  """``iterations`` rounds of erosion (windowed ``all``) or dilation
  (windowed ``any`` over the reflected offsets); outside ``mask`` the
  input stays; ``iterations < 1`` runs to the fixed point."""
  border = bool(border_value)
  op = torch.logical_and if erosion else torch.logical_or

  def kern(*ops):
    xb = ops[0] != 0
    mk = (ops[1] != 0) if masked else None

    def step(cur):
      out = _window_fold(cur, offs, border, op)
      return out if mk is None else torch.where(mk, out, cur)
    if iterations < 1:
      return _fixed_point(step, xb, "erosion_rounds" if erosion
                          else "flood_rounds")
    for _ in range(iterations):
      xb = step(xb)
    return xb
  return kern


def _binary_core(input, structure, iterations, mask, border_value, origin,
                 erosion):
  X = sp.lazify(input)
  st = _structure(structure, len(X.shape))
  _, offs = _fp_offsets(st, origin, not erosion)
  kern = _binary_kernel(offs, border_value, erosion, int(iterations),
                        mask is not None)
  args = [X] if mask is None else [X, sp.lazify(mask)]
  return _mapn_whole(kern, *args)


def binary_erosion(input, structure=None, iterations: int = 1,
                   mask=None, output=None, border_value: int = 0,
                   origin=0, brute_force: bool = False):
  """Binary erosion: the windowed ``all`` over the structuring element;
  ``iterations < 1`` erodes until nothing changes (scipy's)."""
  del output, brute_force
  return _binary_core(input, structure, iterations, mask, border_value,
                      origin, True)


def binary_dilation(input, structure=None, iterations: int = 1,
                    mask=None, output=None, border_value: int = 0,
                    origin=0, brute_force: bool = False):
  """Binary dilation: the windowed ``any`` over the reflected element;
  ``iterations < 1`` dilates until nothing changes."""
  del output, brute_force
  return _binary_core(input, structure, iterations, mask, border_value,
                      origin, False)


def binary_propagation(input, structure=None, mask=None, output=None,
                       border_value: int = 0, origin=0):
  """Geodesic propagation of ``input`` inside ``mask``: dilation to its
  fixed point, ``CHECK_EVERY`` rounds between host reads."""
  del output
  X = sp.lazify(input)
  st = _structure(structure, len(X.shape))
  _, offs = _fp_offsets(st, origin, True)
  border = bool(border_value)

  def kern(*ops):
    mk = None if len(ops) == 1 else (ops[1] != 0)
    seed = (ops[0] != 0) if mk is None else ((ops[0] != 0) & mk)

    def step(cur):
      nxt = _window_fold(cur, offs, border, torch.logical_or) | cur
      return nxt if mk is None else nxt & mk
    return _fixed_point(step, seed, "flood_rounds")
  args = [X] if mask is None else [X, sp.lazify(mask)]
  return _mapn_whole(kern, *args)


def binary_fill_holes(input, structure=None, output=None, origin=0):
  """The complement flooded from the border (a border of ones seeds it);
  the cells of the complement it does not reach are holes."""
  del output
  X = sp.lazify(input)
  st = _structure(structure, len(X.shape))
  _, offs = _fp_offsets(st, origin, True)

  def kern(xx):
    inside = xx != 0
    comp = ~inside
    seed = comp & _window_fold(torch.zeros_like(inside), offs, True,
                               torch.logical_or)

    def step(cur):
      return (_window_fold(cur, offs, True, torch.logical_or) | cur) & comp
    out = _fixed_point(step, seed, "flood_rounds")
    return inside | (comp & ~out)
  return _mapn_whole(kern, X)


def binary_opening(input, structure=None, iterations: int = 1,
                   output=None, origin=0, mask=None,
                   border_value: int = 0, brute_force: bool = False):
  e = binary_erosion(input, structure, iterations, mask, None,
                     border_value, origin, brute_force)
  return binary_dilation(e, structure, iterations, mask, output,
                         border_value, origin, brute_force)


def binary_closing(input, structure=None, iterations: int = 1,
                   output=None, origin=0, mask=None,
                   border_value: int = 0, brute_force: bool = False):
  d = binary_dilation(input, structure, iterations, mask, None,
                      border_value, origin, brute_force)
  return binary_erosion(d, structure, iterations, mask, output,
                        border_value, origin, brute_force)


def binary_hit_or_miss(input, structure1=None, structure2=None,
                       output=None, origin1=0, origin2=None):
  del output
  X = sp.lazify(input)
  s1 = _structure(structure1, len(X.shape))
  s2 = (np.logical_not(s1) if structure2 is None else
        np.asarray(_host_value(sp.lazify(structure2))).astype(bool))
  if origin2 is None:
    origin2 = origin1
  e1 = binary_erosion(X, s1, 1, None, None, 0, origin1)
  e2 = binary_erosion(1 - X, s2, 1, None, None, 0, origin2)
  return sp.logical_and(e1, e2)


# ---------------------------------------------------------------------
# label and the per-label measurements (segment reductions)
# ---------------------------------------------------------------------

def _label_kernel(offs, n_tot):
  """Each foreground pixel takes the least flat index of its component:
  the windowed minimum, then a pointer jump (``cur[cur]``, an index of the
  same component, never larger), to the fixed point.  A root is a pixel
  carrying its own index; a pixel's label is the count of roots up to its
  component's root in raster order."""
  def kern(xx):
    fg = xx != 0
    idt = torch.int32 if n_tot < 2 ** 31 - 1 else torch.int64
    if fg.is_meta:
      return torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    idx = torch.arange(n_tot, dtype=idt, device=fg.device).reshape(fg.shape)
    none = torch.full((), n_tot, dtype=idt, device=fg.device)
    cur = torch.where(fg, idx, none)

    def step(c):
      nxt = torch.where(fg, torch.minimum(
          _window_fold(c, offs, n_tot, torch.minimum), c), none)
      jumped = nxt.reshape(-1)[nxt.clamp(max=n_tot - 1).reshape(-1).long()]
      return torch.where(fg, torch.minimum(nxt, jumped.reshape(nxt.shape)),
                         none)
    cur = _fixed_point(step, cur, "label_rounds")
    roots = (fg & (cur == idx)).reshape(-1).to(torch.int32)
    rank = torch.cumsum(roots, 0, dtype=torch.int32)
    lab = rank[cur.clamp(max=n_tot - 1).reshape(-1).long()].reshape(fg.shape)
    return torch.where(fg, lab, torch.zeros((), dtype=torch.int32,
                                            device=fg.device))
  return kern


def _label_expr(input, structure=None):
  X = sp.lazify(input)
  st = _structure(structure, len(X.shape))
  if st.ndim != len(X.shape):
    raise RuntimeError("structure and input must have equal rank")
  _, offs = _fp_offsets(st, 0, False)
  return _mapn_whole(_label_kernel(offs, int(np.prod(X.shape))), X)


def label(input, structure=None, output=None):
  """Connected components: ``(labels, num_features)``, scipy's labels 1..n
  in raster order of each component's first pixel (int32, on the host, as
  the reference's).  The components are found on the device
  (``_label_kernel``)."""
  del output
  labels = np.asarray(_label_expr(input, structure).glom())
  return labels, int(labels.max()) if labels.size else 0


def _result_dtype(dtype) -> np.dtype:
  """``result_type(dtype, float32)`` as NumPy gives it (bfloat16 as a
  16-bit float)."""
  if dtype in (torch.float32, torch.float16, torch.bfloat16):
    return np.dtype(np.float32)
  return np.dtype(np.float64)


def _index_arr(index):
  idx = np.atleast_1d(np.asarray(_host_value(index)).astype(np.int64))
  return idx, np.ndim(_host_value(index)) == 0


def _slots(lab, uniq):
  """Each pixel's slot in the sorted labels ``uniq`` (``len(uniq)`` for a
  pixel of no listed label)."""
  k = len(uniq)
  if k == 0:
    return torch.zeros_like(lab)
  u = _const(uniq, lab, torch.int64)
  pos = torch.searchsorted(u, lab).clamp(max=k - 1)
  return torch.where(u[pos] == lab, pos, torch.full_like(pos, k))


def _segment_kernel(uniq, whole, wanted):
  """The per-slot statistics ``wanted`` (``count``, ``sum``, ``sumsq``,
  ``min``, ``max``, ``argmin``, ``argmax``, ``com``) of the pixels, one
  float64 row each (``com`` one row an axis); ``whole``: every label above
  0 is one slot."""
  k = 1 if whole else len(uniq)

  def kern(xx, ll):
    x, lab = torch.broadcast_tensors(xx, ll)
    shape = x.shape
    nd = len(shape)
    x = x.reshape(-1).to(torch.float64)
    lab = lab.reshape(-1).to(torch.int64)
    rows = []
    if x.is_meta:
      n_rows = _py.sum(nd if w == "com" else 1 for w in wanted)
      return torch.empty((n_rows, k), dtype=torch.float64, device=x.device)
    slot = (torch.where(lab > 0, 0, 1) if whole else _slots(lab, uniq))
    keep = torch.nonzero(slot < k).reshape(-1)   # compacted: no dump slot
    s, v = slot[keep], x[keep]
    dev = x.device

    def add(vals):
      return torch.zeros(k, dtype=torch.float64, device=dev).index_add_(
          0, s, vals)
    cnt = add(torch.ones_like(v))
    nan = torch.isnan(v)
    has_nan = add(nan.to(torch.float64)) > 0
    for w in wanted:
      if w == "count":
        rows.append(cnt)
      elif w == "sum":
        rows.append(add(v))
      elif w == "sumsq":   # about each slot's mean (two passes, scipy's)
        mu = add(v) / cnt.clamp(min=1.0)
        rows.append(add((v - mu[s]) ** 2))
      elif w in ("min", "max", "argmin", "argmax"):
        is_min = w in ("min", "argmin")
        fill = math.inf if is_min else -math.inf
        clean = torch.where(nan, fill, v)
        ext = torch.full((k,), fill, dtype=torch.float64, device=dev)
        ext = ext.scatter_reduce(0, s, clean, "amin" if is_min else "amax",
                                 include_self=False)
        ext = torch.where(has_nan, math.nan, ext)
        if w in ("min", "max"):
          rows.append(ext)
          continue
        # the first flat index at the extremum (the first NaN where one is)
        match = torch.where(has_nan[s], nan, v == ext[s])
        pos = torch.where(match, keep, torch.full_like(keep, x.numel()))
        first = torch.full((k,), x.numel(), dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, s, pos, "amin", include_self=True)
        rows.append(torch.where(first == x.numel(), 0, first).to(
            torch.float64))
      elif w == "com":
        stride = 1
        coords = []
        for d in range(nd - 1, -1, -1):
          coords.append(((keep // stride) % shape[d]).to(torch.float64))
          stride *= shape[d]
        for c in reversed(coords):
          rows.append(add(v * c))
    return torch.stack(rows) if rows else torch.empty(
        (0, k), dtype=torch.float64, device=dev)
  return kern


def _segments(input, labels, index, wanted):
  """``(stats, scalar, order)``: the rows of ``_segment_kernel`` on the host,
  whether ``index`` was a scalar (or None), and each index's slot."""
  X, L = sp.lazify(input), sp.lazify(labels)
  if index is None:
    uniq, order, scalar, whole = np.zeros(1, np.int64), np.zeros(1, int), \
        True, True
  else:
    idx, scalar = _index_arr(index)
    uniq = np.unique(idx)
    order = np.searchsorted(uniq, idx)
    whole = False
  stats = np.asarray(_mapn_whole(_segment_kernel(uniq, whole, wanted), X,
                                 L).glom())
  return stats[:, order], scalar, _result_dtype(X.dtype)


def _out(vals, scalar):
  return vals[0].item() if scalar else vals


def sum_labels(input, labels=None, index=None):
  """Per-label sums (float64 segment sums, rounded once); without labels
  ``sp.sum``."""
  if labels is None:
    return float(np.asarray(sp.sum(sp.lazify(input)).glom()))
  st, scalar, rt = _segments(input, labels, index, ("sum",))
  return _out(st[0].astype(rt), scalar)


sum = sum_labels  # scipy's alias (shadows builtins.sum in this module)


def mean(input, labels=None, index=None):
  if labels is None:
    return float(np.asarray(sp.mean(sp.lazify(input)).glom()))
  st, scalar, rt = _segments(input, labels, index, ("count", "sum"))
  return _out((st[1] / np.maximum(st[0], 1.0)).astype(rt), scalar)


def variance(input, labels=None, index=None):
  """Per-label variance about each label's mean (two passes, as scipy)."""
  if labels is None:
    return float(np.asarray(sp.var(sp.lazify(input)).glom()))
  st, scalar, rt = _segments(input, labels, index, ("count", "sumsq"))
  return _out((st[1] / np.maximum(st[0], 1.0)).astype(rt), scalar)


def standard_deviation(input, labels=None, index=None):
  return np.sqrt(variance(input, labels, index))


def minimum(input, labels=None, index=None):
  if labels is None:
    return float(np.asarray(sp.min(sp.lazify(input)).glom()))
  st, scalar, rt = _segments(input, labels, index, ("min",))
  return _out(st[0].astype(rt), scalar)


def maximum(input, labels=None, index=None):
  if labels is None:
    return float(np.asarray(sp.max(sp.lazify(input)).glom()))
  st, scalar, rt = _segments(input, labels, index, ("max",))
  return _out(st[0].astype(rt), scalar)


def _positions(flat, shape, scalar):
  pos = [tuple(int(v) for v in np.unravel_index(int(p), shape))
         for p in flat]
  return pos[0] if scalar else pos


def _position(input, labels, index, which):
  X = sp.lazify(input)
  if labels is None:
    flat = int(np.asarray((sp.argmin if which == "argmin" else sp.argmax)(
        X).glom()))
    return tuple(int(v) for v in np.unravel_index(flat, X.shape))
  shape = np.broadcast_shapes(X.shape, sp.lazify(labels).shape)
  st, scalar, _ = _segments(X, labels, index, (which,))
  return _positions(st[0], shape, scalar)


def minimum_position(input, labels=None, index=None):
  return _position(input, labels, index, "argmin")


def maximum_position(input, labels=None, index=None):
  return _position(input, labels, index, "argmax")


def extrema(input, labels=None, index=None):
  """(min, max, min_position, max_position): one segment pass."""
  if labels is None:
    return (minimum(input), maximum(input), minimum_position(input),
            maximum_position(input))
  X = sp.lazify(input)
  shape = np.broadcast_shapes(X.shape, sp.lazify(labels).shape)
  st, scalar, rt = _segments(X, labels, index,
                             ("min", "max", "argmin", "argmax"))
  return (_out(st[0].astype(rt), scalar), _out(st[1].astype(rt), scalar),
          _positions(st[2], shape, scalar), _positions(st[3], shape, scalar))


def center_of_mass(input, labels=None, index=None):
  """Per-label centroids weighted by the input: float64 segment sums of
  ``x`` and of ``x`` times each coordinate (the coordinates computed from
  the flat index on the device)."""
  X = sp.lazify(input)
  if labels is None:
    labels = np.ones((), np.int64)
  st, scalar, _ = _segments(X, labels, index, ("sum", "com"))
  com = st[1:] / st[0]
  out = [tuple(float(v) for v in col) for col in com.T]
  return out[0] if scalar else out


def histogram(input, min, max, bins, labels=None, index=None):
  return _host("histogram", input, min, max, bins, labels, index)


def median(input, labels=None, index=None):
  return _host("median", input, labels=labels, index=index)


def labeled_comprehension(input, labels, index, func, out_dtype,
                          default, pass_positions: bool = False):
  return _host("labeled_comprehension", input, labels, index, func,
               out_dtype, default, pass_positions)


def find_objects(input, max_label: int = 0):
  return _host("find_objects", input, max_label)


def value_indices(arr, *, ignore_value=None):
  return _host("value_indices", arr, ignore_value=ignore_value)


# ---------------------------------------------------------------------
# fourier filters (scipy's multiplier of a ones array, applied lazily)
# ---------------------------------------------------------------------

def _fourier_mult(name, input, args, n, axis):
  X = sp.lazify(input)
  dt = to_numpy_dtype(X.dtype)
  ones = np.ones(X.shape, complex if dt.kind == "c" else float)
  m = getattr(_ndi, name)(ones, *args, n=n, axis=axis)
  if dt.kind in "fc":
    m = m.astype(dt)  # scipy's: the input's dtype
  return X * sp.Val(np.asarray(m))


def fourier_gaussian(input, sigma, n: int = -1, axis: int = -1,
                     output=None):
  del output
  return _fourier_mult("fourier_gaussian", input, (sigma,), n, axis)


def fourier_uniform(input, size, n: int = -1, axis: int = -1,
                    output=None):
  del output
  return _fourier_mult("fourier_uniform", input, (size,), n, axis)


def fourier_ellipsoid(input, size, n: int = -1, axis: int = -1,
                      output=None):
  del output
  return _fourier_mult("fourier_ellipsoid", input, (size,), n, axis)


def fourier_shift(input, shift, n: int = -1, axis: int = -1,
                  output=None):
  del output
  return _fourier_mult("fourier_shift", input, (shift,), n, axis)


# ---------------------------------------------------------------------
# interpolation: device gathers at order <= 1, host splines above
# ---------------------------------------------------------------------

def _round_away(c):
  """Round half away from zero (``lax.round``), exactly."""
  t = torch.trunc(c)
  return torch.where(torch.abs(c - t) >= 0.5, t + torch.sign(c), t)


def _fix_index(index, size, mode):
  if mode == "nearest":
    return index.clamp(0, size - 1)
  if mode == "wrap":
    return torch.remainder(index, size)
  if mode == "mirror":
    s = size - 1
    return torch.abs(torch.remainder(index + s, 2 * s) - s) if s else (
        torch.zeros_like(index))
  if mode == "reflect":
    s = 2 * size
    m = torch.abs(torch.remainder(2 * index + 1 + s, 2 * s) - s)
    return torch.div(m - 1, 2, rounding_mode="floor")
  return index


def _interpolate(x, coords, order, mode, cval):
  """``jax.scipy.ndimage.map_coordinates`` in torch, then scipy's ``cval``
  for a coordinate outside ``[0, n - 1]`` in ``constant`` mode."""
  nd = x.ndim
  cv = torch.tensor(cval, device=x.device).to(x.dtype)
  per_axis = []
  for d in range(nd):
    c = coords[d]
    size = x.shape[d]
    if order == 0:
      nodes = [(_round_away(c).to(torch.int64), None)]
    else:
      lower = torch.floor(c)
      upper_w = c - lower
      idx = lower.to(torch.int64)
      nodes = [(idx, 1 - upper_w), (idx + 1, upper_w)]
    per_axis.append([(_fix_index(i, size, mode),
                      ((i >= 0) & (i < size)) if mode == "constant" else None,
                      w) for i, w in nodes])
  out = None
  for items in itertools.product(*per_axis):
    idx = tuple(i for i, _, _ in items)
    valid = [v for _, v, _ in items if v is not None]
    if mode == "constant":
      safe = tuple(i.clamp(0, n - 1) for i, n in zip(idx, x.shape))
      val = x[safe]
      ok = valid[0]
      for v in valid[1:]:
        ok = ok & v
      val = torch.where(ok, val, cv)
    else:
      val = x[idx]
    ws = [w for _, _, w in items if w is not None]
    term = val
    if ws:
      prod = ws[0]
      for w in ws[1:]:
        prod = prod * w
      term = prod * val
    out = term if out is None else out + term
  if not (x.is_floating_point() or x.is_complex()):
    out = _round_away(out)
  out = out.to(x.dtype)
  if mode == "constant":
    ok = None
    for d in range(nd):
      v = (coords[d] >= 0) & (coords[d] <= x.shape[d] - 1)
      ok = v if ok is None else ok & v
    out = torch.where(ok, out, cv)
  return out


def _coords_kernel(order, mode, cval):
  def kern(xx, cc):
    if cc.shape[0] != xx.ndim:
      raise ValueError("coordinates must be a sequence of length "
                       "input.ndim")
    return _interpolate(xx, list(cc), order, mode, cval)
  return kern


def _on_device(order, mode):
  return order <= 1 and mode in _JAX_COORD_MODES


def map_coordinates(input, coordinates, output=None, order: int = 3,
                    mode: str = "constant", cval: float = 0.0,
                    prefilter: bool = True):
  """Interpolation at the given coordinates: on the device at order <= 1
  (``jax.scipy.ndimage``'s gather and blend), else scipy on the host."""
  del output
  if not _on_device(order, mode):
    return _host("map_coordinates", input, coordinates, order=order,
                 mode=mode, cval=cval, prefilter=prefilter)
  return _mapn_whole(_coords_kernel(order, mode, cval), sp.lazify(input),
                     sp.lazify(coordinates))


def _affine_kernel(shape_out, matrix, offset, order, mode, cval):
  """The output grid mapped by ``matrix`` and ``offset`` on the device,
  then interpolated."""
  nd = len(shape_out)

  def kern(xx):
    dev = xx.device
    axes = [torch.arange(n, dtype=torch.float64, device=dev).reshape(
        (1,) * d + (n,) + (1,) * (nd - d - 1))
            for d, n in enumerate(shape_out)]
    coords = []
    for i in range(nd):
      c = None
      for j in range(nd):
        if matrix[i, j] != 0:
          t = float(matrix[i, j]) * axes[j]
          c = t if c is None else c + t
      c = torch.zeros((1,) * nd, dtype=torch.float64, device=dev) \
          if c is None else c
      coords.append(torch.broadcast_to(c + float(offset[i]), shape_out))
    return _interpolate(xx, coords, order, mode, cval)
  return kern


def affine_transform(input, matrix, offset=0.0, output_shape=None,
                     output=None, order: int = 3,
                     mode: str = "constant", cval: float = 0.0,
                     prefilter: bool = True):
  """Affine warp: the grid built and mapped on the device, then the
  order <= 1 gather; higher orders on the host."""
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  m = np.asarray(_host_value(sp.lazify(matrix)), dtype=float)
  off = np.broadcast_to(np.asarray(offset, float), (nd,))
  if m.ndim == 1:
    m = np.diag(m)
  elif m.ndim == 2 and m.shape == (nd + 1, nd + 1):
    off = m[:nd, nd]
    m = m[:nd, :nd]
  elif m.ndim == 2 and m.shape == (nd, nd + 1):
    off = m[:, nd]
    m = m[:, :nd]
  shape_out = tuple(int(s) for s in output_shape) \
      if output_shape is not None else tuple(X.shape)
  if not _on_device(order, mode):
    return _host("affine_transform", X, m, offset=off,
                 output_shape=shape_out, order=order, mode=mode, cval=cval,
                 prefilter=prefilter)
  return _mapn_whole(_affine_kernel(shape_out, m, off, order, mode, cval),
                     X)


def shift(input, shift, output=None, order: int = 3,
          mode: str = "constant", cval: float = 0.0,
          prefilter: bool = True):
  X = sp.lazify(input)
  nd = len(X.shape)
  sh = np.broadcast_to(np.asarray(shift, float), (nd,))
  return affine_transform(X, np.eye(nd), offset=-sh, output=output,
                          order=order, mode=mode, cval=cval,
                          prefilter=prefilter)


def _zoom_kernel(shape_out, order, mode, cval):
  """scipy's endpoint-preserving grid ``i (s - 1) / (o - 1)`` (the product
  of exact integers first, so the last point is exactly ``s - 1``)."""
  nd = len(shape_out)

  def kern(xx):
    coords = []
    for d, (s, o) in enumerate(zip(xx.shape, shape_out)):
      a = torch.arange(o, dtype=torch.float64, device=xx.device) * (s - 1) \
          / max(o - 1, 1)
      coords.append(torch.broadcast_to(
          a.reshape((1,) * d + (o,) + (1,) * (nd - d - 1)), shape_out))
    return _interpolate(xx, coords, order, mode, cval)
  return kern


def zoom(input, zoom, output=None, order: int = 3,
         mode: str = "constant", cval: float = 0.0,
         prefilter: bool = True, *, grid_mode: bool = False):
  del output
  X = sp.lazify(input)
  nd = len(X.shape)
  z = np.broadcast_to(np.asarray(zoom, float), (nd,))
  shape_out = tuple(int(round(s * zz)) for s, zz in zip(X.shape, z))
  if grid_mode or not _on_device(order, mode):
    return _host("zoom", X, z, order=order, mode=mode, cval=cval,
                 prefilter=prefilter, grid_mode=grid_mode)
  return _mapn_whole(_zoom_kernel(shape_out, order, mode, cval), X)


def _cos_sin_deg(angle):
  """cos and sin of ``angle`` degrees, exact at multiples of 90."""
  a = float(angle) % 360.0
  exact = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0), 180.0: (-1.0, 0.0),
           270.0: (0.0, -1.0)}
  if a in exact:
    return exact[a]
  r = np.deg2rad(float(angle))
  return float(np.cos(r)), float(np.sin(r))


def rotate(input, angle: float, axes=(1, 0), reshape: bool = True,
           output=None, order: int = 3, mode: str = "constant",
           cval: float = 0.0, prefilter: bool = True):
  """Plane rotation of a 2-D image (scipy's matrix, shape and centres),
  the grid mapped on the device (order <= 1); N-D on the host."""
  X = sp.lazify(input)
  nd = len(X.shape)
  ax = sorted(a % nd for a in axes)
  if nd != 2 or ax != [0, 1] or not _on_device(order, mode):
    return _host("rotate", X, angle, axes=axes, reshape=reshape,
                 order=order, mode=mode, cval=cval, prefilter=prefilter)
  c, s = _cos_sin_deg(angle)
  R = np.array([[c, s], [-s, c]])
  in_shape = np.asarray(X.shape)
  if reshape:
    iy, ix = in_shape
    bounds = R @ np.array([[0, 0, iy, iy], [0, ix, 0, ix]])
    out_shape = (np.ptp(bounds, axis=1) + 0.5).astype(int)
  else:
    out_shape = in_shape
  offset = (in_shape - 1) / 2 - R @ ((out_shape - 1) / 2)
  return affine_transform(X, R, offset=offset,
                          output_shape=tuple(int(v) for v in out_shape),
                          output=output, order=order, mode=mode, cval=cval,
                          prefilter=prefilter)


def geometric_transform(input, mapping, output_shape=None, output=None,
                        order: int = 3, mode: str = "constant",
                        cval: float = 0.0, prefilter: bool = True,
                        extra_arguments=(), extra_keywords=None):
  return _host("geometric_transform", input, mapping,
               output_shape=output_shape, order=order, mode=mode,
               cval=cval, prefilter=prefilter,
               extra_arguments=extra_arguments,
               extra_keywords=extra_keywords or {})


def spline_filter(input, order: int = 3, output=np.float64,
                  mode: str = "mirror"):
  return _host("spline_filter", input, order, output=output, mode=mode)


def spline_filter1d(input, order: int = 3, axis: int = -1,
                    output=np.float64, mode: str = "mirror"):
  return _host("spline_filter1d", input, order, axis=axis, output=output,
               mode=mode)


# ---------------------------------------------------------------------
# host boundaries
# ---------------------------------------------------------------------

def distance_transform_edt(input, sampling=None,
                           return_distances: bool = True,
                           return_indices: bool = False,
                           distances=None, indices=None):
  return _host("distance_transform_edt", input, sampling=sampling,
               return_distances=return_distances,
               return_indices=return_indices, distances=distances,
               indices=indices)


def distance_transform_cdt(input, metric="chessboard",
                           return_distances: bool = True,
                           return_indices: bool = False,
                           distances=None, indices=None):
  return _host("distance_transform_cdt", input, metric=metric,
               return_distances=return_distances,
               return_indices=return_indices, distances=distances,
               indices=indices)


def distance_transform_bf(input, metric="euclidean", sampling=None,
                          return_distances: bool = True,
                          return_indices: bool = False, distances=None,
                          indices=None):
  return _host("distance_transform_bf", input, metric=metric,
               sampling=sampling, return_distances=return_distances,
               return_indices=return_indices, distances=distances,
               indices=indices)


def watershed_ift(input, markers, structure=None, output=None):
  del output
  return _host("watershed_ift", input, markers, structure=structure)


def generic_filter(input, function, size=None, footprint=None,
                   output=None, mode: str = "reflect", cval: float = 0.0,
                   origin=0, extra_arguments=(), extra_keywords=None):
  """A Python callable a window: a host boundary (``vectorized_filter``
  runs a vectorized callable on the device)."""
  del output
  return _host("generic_filter", input, function, size=size,
               footprint=footprint, mode=mode, cval=cval, origin=origin,
               extra_arguments=extra_arguments,
               extra_keywords=extra_keywords or {})


def generic_filter1d(input, function, filter_size, axis: int = -1,
                     output=None, mode: str = "reflect",
                     cval: float = 0.0, origin=0, extra_arguments=(),
                     extra_keywords=None):
  del output
  return _host("generic_filter1d", input, function, filter_size, axis=axis,
               mode=mode, cval=cval, origin=origin,
               extra_arguments=extra_arguments,
               extra_keywords=extra_keywords or {})
