"""``sp.fft``: the ``numpy.fft`` surface and ``scipy.fft``'s extras over lazy
exprs (port of ``spartan_tpu/fft.py``).

Every transform is a lazy map over ``torch.fft`` on the mesh's device
(cuFFT on the card), where the reference maps ``jnp.fft``; the transform
runs whole, as the reference's does on one device.  Dtypes follow NumPy 2:
float32 (and complex64) in gives complex64 (float32) out, float64 gives
complex128, integers and bool compute in float64.  ``fftfreq`` and
``rfftfreq`` are small leaves built on the host.

The extras follow the reference's own algorithms, in torch:

* the DCT/DST types 1-4 (``dct`` … ``idstn``): one real FFT of a symmetric
  extension (types 1 and 2) or a half-sample-phased, zero-padded complex
  FFT (types 3 and 4); the DST types 2-4 through the DCT by flips and
  alternating signs; the n-D forms apply the 1-D transform axis by axis;
  the phases are in the input's precision, so float32 gives float32 for
  every type (scipy's dtype);
* ``hfft2``/``hfftn``/``ihfft2``/``ihfftn``: ``irfftn`` of the conjugate
  scaled by the transform's size, and the conjugate of ``rfftn``, with the
  norm modes moved to the other direction;
* ``fht``/``ifht``: FFTLog (Hamilton 2000), its coefficients computed
  once on the host with scipy's ``loggamma``, then an ``rfft``, a product
  and an ``irfft`` on the device.

``fhtoffset``, ``next_fast_len``, ``prev_fast_len``, ``get_workers`` and
``set_workers`` are scipy's own.  The reference's distributed pencil and
four-step transforms (``--fft_pencil``) need several devices and wait for
the multi-device layer.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr.map import structural

__all__ = ["fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "fftn",
           "ifftn", "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]

_NORMS = (None, "backward", "ortho", "forward")


def _check_norm(norm) -> None:
  if norm not in _NORMS:
    raise ValueError(f"Invalid norm value {norm!r}; should be 'backward', "
                     "'ortho' or 'forward'.")


def _inexact(a: torch.Tensor) -> torch.Tensor:
  """Integers and bool as float64 (NumPy's), floats and complex as they
  are."""
  if a.is_floating_point() or a.is_complex():
    return a
  return a.to(torch.float64)


@structural
def _fft_call(a, name: str, **kw):
  # ihfft returns a lazily conjugated view: materialize it
  return getattr(torch.fft, name)(_inexact(a), **kw).resolve_conj()


def _fft_map(v, name: str, **kw):
  _check_norm(kw.get("norm"))
  kw = {k: w for k, w in kw.items() if w is not None}
  return sp.map([sp.lazify(v)], _fft_call, fn_kw={"name": name, **kw})


def _tup(s):
  return None if s is None else tuple(int(i) for i in s)


def fft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "fft", n=n, dim=axis, norm=norm)


def ifft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "ifft", n=n, dim=axis, norm=norm)


def rfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "rfft", n=n, dim=axis, norm=norm)


def irfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "irfft", n=n, dim=axis, norm=norm)


def fft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "fft2", s=_tup(s), dim=_tup(axes), norm=norm)


def ifft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "ifft2", s=_tup(s), dim=_tup(axes), norm=norm)


def fftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "fftn", s=_tup(s), dim=_tup(axes), norm=norm)


def ifftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "ifftn", s=_tup(s), dim=_tup(axes), norm=norm)


def rfft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "rfft2", s=_tup(s), dim=_tup(axes), norm=norm)


def irfft2(v, s=None, axes=(-2, -1), norm=None):
  return _fft_map(v, "irfft2", s=_tup(s), dim=_tup(axes), norm=norm)


def rfftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "rfftn", s=_tup(s), dim=_tup(axes), norm=norm)


def irfftn(v, s=None, axes=None, norm=None):
  return _fft_map(v, "irfftn", s=_tup(s), dim=_tup(axes), norm=norm)


def hfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "hfft", n=n, dim=axis, norm=norm)


def ihfft(v, n=None, axis=-1, norm=None):
  return _fft_map(v, "ihfft", n=n, dim=axis, norm=norm)


def _shift_axes(axes):
  return int(axes) if np.isscalar(axes) else _tup(axes)


def fftshift(v, axes=None):
  return _fft_map(v, "fftshift", dim=_shift_axes(axes))


def ifftshift(v, axes=None):
  return _fft_map(v, "ifftshift", dim=_shift_axes(axes))


def fftfreq(n, d=1.0):
  return sp.from_numpy(np.fft.fftfreq(int(n), d))


def rfftfreq(n, d=1.0):
  return sp.from_numpy(np.fft.rfftfreq(int(n), d))


# ---------------------------------------------------------------------------
# scipy.fft's extras: the DCT/DST families, Hermitian n-D, the fast Hankel
# transform
# ---------------------------------------------------------------------------

__all__ += ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn",
            "idstn", "hfft2", "hfftn", "ihfft2", "ihfftn", "fht",
            "ifht", "fhtoffset", "next_fast_len", "prev_fast_len",
            "set_workers", "get_workers"]


def _complex_of(x: torch.Tensor) -> torch.dtype:
  return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _phase(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """``exp(1j · angle)`` in ``x``'s complex precision."""
  return torch.polar(torch.ones_like(angle), angle).to(_complex_of(x))


def _dct1d(x: torch.Tensor, type: int) -> torch.Tensor:
  """The backward-normed DCT along the last axis."""
  N = x.shape[-1]
  if type == 1:
    if N < 2:
      raise ValueError("DCT-I requires length >= 2")
    w = torch.cat([x, x[..., 1:-1].flip(-1)], -1)  # the 2N-2 extension
    return torch.fft.rfft(w)[..., :N].real
  if type == 2:
    w = x.new_zeros(x.shape[:-1] + (4 * N,))  # interleaved symmetric
    w[..., 1:2 * N:2] = x
    w[..., 2 * N + 1:4 * N:2] = x.flip(-1)
    return torch.fft.rfft(w)[..., :N].real
  ar = torch.arange(N, dtype=x.dtype, device=x.device)
  if type == 3:
    xt = x * torch.where(ar == 0, 1.0, 2.0).to(x.dtype)
    z = xt * _phase(x, torch.pi * ar / (2 * N))
    z = torch.cat([z, torch.zeros_like(z)], -1)
    return (torch.fft.ifft(z, dim=-1) * (2 * N))[..., :N].real
  if type == 4:
    z = x * _phase(x, -torch.pi * ar / (2 * N))
    z = torch.cat([z, torch.zeros_like(z)], -1)
    F = torch.fft.fft(z, dim=-1)[..., :N]
    return 2.0 * (_phase(x, -torch.pi * (2 * ar + 1) / (4 * N)) * F).real
  raise ValueError(f"DCT type must be 1-4, got {type}")


def _dst1d(x: torch.Tensor, type: int) -> torch.Tensor:
  """The backward-normed DST along the last axis; types 2-4 through the
  DCT by the flip and alternating-sign identities."""
  N = x.shape[-1]
  if type == 1:
    w = x.new_zeros(x.shape[:-1] + (2 * N + 2,))  # the odd extension
    w[..., 1:N + 1] = x
    w[..., N + 2:] = -x.flip(-1)
    return -torch.fft.rfft(w)[..., 1:N + 1].imag
  ar = torch.arange(N, device=x.device)
  s = torch.where(ar % 2 == 0, 1.0, -1.0).to(x.dtype)
  if type == 2:
    return _dct1d(x * s, 2).flip(-1)
  if type in (3, 4):
    return _dct1d(x.flip(-1), type) * s
  raise ValueError(f"DST type must be 1-4, got {type}")


def _cos_den(kind: str, type: int, N: int) -> float:
  if type == 1:
    return 2.0 * (N - 1) if kind == "dct" else 2.0 * (N + 1)
  return 2.0 * N


_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}
_INV_NORM = {"backward": "forward", "forward": "backward", "ortho": "ortho"}


def _scaled(x: torch.Tensor, idx: int, f: float) -> torch.Tensor:
  y = x.clone()
  y[..., idx] = y[..., idx] * f
  return y


def _cosine_axis(x, kind, type, n, axis, norm, orthogonalize):
  """One axis of scipy's DCT/DST with its ``n``, norm and
  ``orthogonalize``."""
  x = torch.movedim(x, axis, -1)
  if n is not None:
    cur = x.shape[-1]
    if n < cur:
      x = x[..., :n]
    elif n > cur:
      x = torch.nn.functional.pad(x, (0, n - cur))
  N = x.shape[-1]
  adj = orthogonalize if orthogonalize is not None else norm == "ortho"
  r2 = float(np.sqrt(2.0))
  if adj:
    if kind == "dct" and type == 3:
      x = _scaled(x, 0, r2)
    elif kind == "dct" and type == 1:
      x = _scaled(_scaled(x, 0, r2), -1, r2)
    elif kind == "dst" and type == 3:
      x = _scaled(x, -1, r2)
  y = _dct1d(x, type) if kind == "dct" else _dst1d(x, type)
  if adj:
    if kind == "dct" and type == 2:
      y = _scaled(y, 0, 1 / r2)
    elif kind == "dct" and type == 1:
      y = _scaled(_scaled(y, 0, 1 / r2), -1, 1 / r2)
    elif kind == "dst" and type == 2:
      y = _scaled(y, -1, 1 / r2)
  den = _cos_den(kind, type, N)
  if norm == "ortho":
    y = y / np.sqrt(den)
  elif norm == "forward":
    y = y / den
  return torch.movedim(y, -1, axis)


def _cosine_axes(x, kind, inverse, type, sizes, axes, norm, orthogonalize):
  _check_norm(norm)
  norm = norm or "backward"
  type = int(type)
  if inverse:
    type, norm = _INV_TYPE[type], _INV_NORM[norm]
  x = _inexact(x)
  if x.is_complex():  # scipy transforms the real and imaginary parts apart
    parts = [x.real, x.imag]
  else:
    parts = [x]
  for ax, n in zip(axes, sizes):
    parts = [_cosine_axis(p, kind, type, n, ax, norm, orthogonalize)
             for p in parts]
  return parts[0] if len(parts) == 1 else torch.complex(*parts)


@structural
def _cosine_call(x, kind, inverse, type, n, axis, norm, orthogonalize):
  return _cosine_axes(x, kind, inverse, type, (n,), (axis % x.ndim,), norm,
                      orthogonalize)


@structural
def _cosine_nd_call(x, kind, inverse, type, s, axes, norm, orthogonalize):
  if axes is None:
    axes = (tuple(range(x.ndim)) if s is None
            else tuple(range(x.ndim - len(s), x.ndim)))
  axes = tuple(ax % x.ndim for ax in axes)
  sizes = (None,) * len(axes) if s is None else tuple(s)
  return _cosine_axes(x, kind, inverse, type, sizes, axes, norm,
                      orthogonalize)


def _cosine_map(v, fn, **kw):
  _check_norm(kw["norm"])
  return sp.map([sp.lazify(v)], fn, fn_kw=kw)


def dct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
        workers=None, *, orthogonalize=None):
  """``scipy.fft.dct``: one real FFT of an extension (see the module
  docstring)."""
  return _cosine_map(x, _cosine_call, kind="dct", inverse=False, type=type,
                     n=n, axis=axis, norm=norm, orthogonalize=orthogonalize)


def idct(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  return _cosine_map(x, _cosine_call, kind="dct", inverse=True, type=type,
                     n=n, axis=axis, norm=norm, orthogonalize=orthogonalize)


def dst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
        workers=None, *, orthogonalize=None):
  return _cosine_map(x, _cosine_call, kind="dst", inverse=False, type=type,
                     n=n, axis=axis, norm=norm, orthogonalize=orthogonalize)


def idst(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  return _cosine_map(x, _cosine_call, kind="dst", inverse=True, type=type,
                     n=n, axis=axis, norm=norm, orthogonalize=orthogonalize)


def _cosine_nd(x, kind, inverse, type, s, axes, norm, orthogonalize):
  return _cosine_map(x, _cosine_nd_call, kind=kind, inverse=inverse,
                     type=type, s=_tup(s), axes=_tup(axes), norm=norm,
                     orthogonalize=orthogonalize)


def dctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  """``scipy.fft.dctn``: the 1-D transform axis by axis."""
  return _cosine_nd(x, "dct", False, type, s, axes, norm, orthogonalize)


def idctn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, *, orthogonalize=None):
  return _cosine_nd(x, "dct", True, type, s, axes, norm, orthogonalize)


def dstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
         workers=None, *, orthogonalize=None):
  return _cosine_nd(x, "dst", False, type, s, axes, norm, orthogonalize)


def idstn(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, *, orthogonalize=None):
  return _cosine_nd(x, "dst", True, type, s, axes, norm, orthogonalize)


# -- Hermitian n-D --------------------------------------------------------

@structural
def _hfftn_call(x, inverse, s, axes, norm):
  """``hfftn`` is ``irfftn(conj(x))`` times the transform's size, its norm
  modes the forward direction's; ``ihfftn`` is ``conj(rfftn(x))`` with the
  inverse direction's."""
  x = _inexact(x)
  if axes is None:
    axes = (tuple(range(x.ndim)) if s is None
            else tuple(range(x.ndim - len(s), x.ndim)))
  axes = tuple(ax % x.ndim for ax in axes)
  if inverse:
    y = torch.conj(torch.fft.rfftn(x, s=s, dim=axes)).resolve_conj()
    n_tot = float(np.prod([x.shape[ax] if s is None else s[i]
                           for i, ax in enumerate(axes)]))
    if norm in (None, "backward"):
      return y / n_tot
    return y / np.sqrt(n_tot) if norm == "ortho" else y
  y = torch.fft.irfftn(torch.conj(x).resolve_conj(), s=s, dim=axes)
  n_tot = float(np.prod([y.shape[ax] for ax in axes]))
  y = y * n_tot
  if norm == "ortho":
    return y / np.sqrt(n_tot)
  return y / n_tot if norm == "forward" else y


def _hfftn_map(v, inverse, s, axes, norm):
  _check_norm(norm)
  return sp.map([sp.lazify(v)], _hfftn_call,
                fn_kw={"inverse": inverse, "s": _tup(s), "axes": _tup(axes),
                       "norm": norm})


def hfft2(x, s=None, axes=(-2, -1), norm=None):
  return _hfftn_map(x, False, s, axes, norm)


def hfftn(x, s=None, axes=None, norm=None):
  return _hfftn_map(x, False, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm=None):
  return _hfftn_map(x, True, s, axes, norm)


def ihfftn(x, s=None, axes=None, norm=None):
  return _hfftn_map(x, True, s, axes, norm)


# -- the fast Hankel transform (FFTLog) -----------------------------------

def _fht_coeff(n, dln, mu, offset, bias):
  """FFTLog's u_m coefficients (Hamilton 2000, eqs. 16-18), on the host."""
  from scipy.special import loggamma
  m = np.arange(n // 2 + 1)
  y = np.pi * m / (n * dln)
  xp = (mu + 1 + bias) / 2
  xm = (mu + 1 - bias) / 2
  v = loggamma(xp + 1j * y) - loggamma(xm - 1j * y)
  u = np.exp((bias + 2j * y) * np.log(2.0) - 2j * y * offset + v)
  if n % 2 == 0:
    u[-1] = u[-1].real  # low ringing: a real Nyquist coefficient
  return u


@structural
def _fht_call(a, dln, mu, offset, bias, inverse):
  a = _inexact(a)
  n = a.shape[-1]
  u = torch.as_tensor(_fht_coeff(n, dln, mu, offset, bias), device=a.device)
  j = np.arange(n)
  pre = post = None
  if bias:
    pre = torch.as_tensor(np.exp(-bias * (j - (n - 1) / 2) * dln),
                          device=a.device)
    post = torch.as_tensor(
        np.exp(-bias * ((j - (n - 1) / 2) * dln + offset)), device=a.device)
  if not inverse:
    if pre is not None:
      a = a * pre
    out = torch.fft.irfft(torch.fft.rfft(a, dim=-1) * u, n, dim=-1).flip(-1)
    return out * post if post is not None else out
  if post is not None:
    a = a / post
  out = torch.fft.irfft(torch.fft.rfft(a, dim=-1) / torch.conj(u), n,
                        dim=-1).flip(-1)
  return out / pre if pre is not None else out


def _fht_map(a, dln, mu, offset, bias, inverse):
  return sp.map([sp.lazify(a)], _fht_call,
                fn_kw={"dln": float(dln), "mu": float(mu),
                       "offset": float(offset), "bias": float(bias),
                       "inverse": inverse})


def fht(a, dln, mu, offset=0.0, bias=0.0):
  """``scipy.fft.fht`` by FFTLog."""
  return _fht_map(a, dln, mu, offset, bias, False)


def ifht(A, dln, mu, offset=0.0, bias=0.0):
  """``scipy.fft.ifht``, the exact inverse (a division by conj(u))."""
  return _fht_map(A, dln, mu, offset, bias, True)


# -- host helpers: scipy's own --------------------------------------------

from scipy.fft import fhtoffset  # noqa: E402
from scipy.fft import next_fast_len, prev_fast_len  # noqa: E402
from scipy.fft import get_workers, set_workers  # noqa: E402
