"""``sp.fft`` in both packages on the same seeded inputs: the counterparts
of the one-device cases of the reference's ``tests/test_fft.py`` (its
pencil and four-step cases need several devices and ``grad``), held to the
reference on its mesh, to NumPy and to scipy, with Poisson's spectral
solver.

Tolerances, relative to the largest entry of the oracle:
* float64 against NumPy, scipy and the reference: ``TOL`` = 1e-12.  The
  three FFTs (torch's pocketfft, NumPy's pocketfft, XLA's DUCC) sum in
  other orders; an FFT of length N errs by about log2(N) · 2^-53 of the
  largest coefficient, below 1e-14 for these lengths, and the DCT/DST and
  FFTLog wrappers add a few roundings.
* float32: ``TOL32`` = 1e-5 (the same bound at 2^-24).
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import spartan_tpu as ref
from spartan_tpu.examples import poisson as rpoisson

import spartan_tpu_torch as sp
from spartan_tpu_torch.examples import poisson

TOL = 1e-12
TOL32 = 1e-5


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _g(e):
  return np.asarray(sp.lazify(e).glom())


def _r(e):
  return np.asarray(ref.lazify(e).glom())


def _close(got, want, tol=TOL):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype, (
      got.shape, want.shape, got.dtype, want.dtype)
  scale = max(float(np.abs(want).max()), 1e-300)
  assert float(np.abs(got - want).max()) <= tol * scale, (
      float(np.abs(got - want).max()) / scale)


def test_the_surface_is_the_references():
  assert sorted(sp.fft.__all__) == sorted(ref.fft.__all__)
  for name in ref.fft.__all__:
    assert callable(getattr(sp.fft, name)), name


@pytest.mark.parametrize("name,kw", [
    ("fft", {}), ("ifft", {}), ("fft", {"n": 20, "axis": 0}),
    ("fft2", {}), ("ifft2", {}), ("fftn", {}), ("ifftn", {}),
    ("fftn", {"s": (8, 40), "axes": (0, 1)}), ("fft2", {"axes": (1, 0)}),
    ("hfft", {}), ("ifftshift", {}), ("fftshift", {"axes": (0,)})])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_complex_transforms(rng, name, kw, norm):
  z = rng.standard_normal((16, 32)) + 1j * rng.standard_normal((16, 32))
  if name.endswith("shift"):
    if norm is not None:
      return
    got = getattr(sp.fft, name)(sp.from_numpy(z), **kw)
    want = getattr(np.fft, name)(z, **kw)
  else:
    got = getattr(sp.fft, name)(sp.from_numpy(z), norm=norm, **kw)
    want = getattr(np.fft, name)(z, norm=norm, **kw)
  _close(_g(got), want)
  np_kw = {k: v for k, v in kw.items()}
  rwant = (getattr(ref.fft, name)(ref.from_numpy(z), **np_kw)
           if name.endswith("shift") else
           getattr(ref.fft, name)(ref.from_numpy(z), norm=norm, **np_kw))
  _close(_g(got), _r(rwant))


@pytest.mark.parametrize("name,kw", [
    ("rfft", {}), ("rfft", {"n": 8, "axis": 0}), ("rfft2", {}),
    ("rfftn", {}), ("ihfft", {}), ("rfftn", {"axes": (0,)})])
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_real_transforms_and_their_inverses(rng, name, kw, norm):
  r = rng.standard_normal((8, 64))
  got = _g(getattr(sp.fft, name)(sp.from_numpy(r), norm=norm, **kw))
  _close(got, getattr(np.fft, name)(r, norm=norm, **kw))
  _close(got, _r(getattr(ref.fft, name)(ref.from_numpy(r), norm=norm,
                                        **kw)))
  inverse = {"rfft": "irfft", "rfft2": "irfft2", "rfftn": "irfftn",
             "ihfft": "hfft"}[name]
  n_kw = dict(kw)
  if "n" in n_kw or name in ("rfft", "ihfft"):
    n_kw["n"] = r.shape[n_kw.get("axis", -1)]
  elif name in ("rfft2", "rfftn"):
    n_kw.setdefault("axes", (0, 1))
    n_kw["s"] = tuple(r.shape[a] for a in n_kw["axes"])
  back = _g(getattr(sp.fft, inverse)(sp.from_numpy(got), norm=norm, **n_kw))
  _close(back, getattr(np.fft, inverse)(got, norm=norm, **n_kw))
  _close(back, r, 1e-11)


def test_shift_of_an_int_axis_follows_numpy(rng):
  """``fftshift(v, axes=0)``: NumPy's shift of axis 0.  The reference
  raises ``TypeError`` there (it takes ``tuple(axes)`` of the int)."""
  z = rng.standard_normal((5, 6))
  _close(_g(sp.fft.fftshift(z, axes=0)), np.fft.fftshift(z, axes=0))
  _close(_g(sp.fft.ifftshift(z, axes=-1)), np.fft.ifftshift(z, axes=-1))
  with pytest.raises(TypeError):
    ref.fft.fftshift(z, axes=0)


def test_dtypes_follow_numpy_2(rng):
  """float32 in gives complex64 out (NumPy 2.0 and the reference);
  integers compute in float64; the inverse real transform of complex64
  gives float32."""
  r32 = rng.standard_normal((8, 64)).astype(np.float32)
  for name in ("fft", "rfft", "fft2", "rfftn", "ihfft"):
    got = _g(getattr(sp.fft, name)(r32))
    want = getattr(np.fft, name)(r32)
    assert got.dtype == want.dtype == np.complex64
    assert got.dtype == _r(getattr(ref.fft, name)(ref.from_numpy(r32))).dtype
    _close(got, want, TOL32)
  c64 = np.fft.rfft(r32)
  assert _g(sp.fft.irfft(c64)).dtype == np.float32
  ints = rng.integers(-5, 5, (4, 16))
  got = _g(sp.fft.fft(ints))
  assert got.dtype == np.complex128
  _close(got, np.fft.fft(ints))


def test_invalid_norm_raises():
  z = np.ones((4, 4))
  for fn in (sp.fft.fft2, sp.fft.fft, sp.fft.dct, sp.fft.hfftn):
    with pytest.raises(ValueError):
      fn(z, norm="bogus")


def test_frequencies(rng):
  _close(_g(sp.fft.fftfreq(64, d=0.5)), np.fft.fftfreq(64, d=0.5))
  _close(_g(sp.fft.rfftfreq(63)), np.fft.rfftfreq(63))


def test_fft_composes_with_dag(rng):
  """Spectral filtering: fft, mask, ifft, real, all lazy in one chain."""
  r = rng.standard_normal(128)
  k = np.abs(np.fft.fftfreq(128))
  keep = (k < 0.1).astype(np.complex128)
  got = _g(sp.real(sp.fft.ifft(sp.fft.fft(sp.from_numpy(r))
                               * sp.from_numpy(keep))))
  want = np.real(np.fft.ifft(np.fft.fft(r) * keep))
  _close(got, want)
  rwant = _r(ref.real(ref.fft.ifft(ref.fft.fft(ref.from_numpy(r))
                                   * ref.from_numpy(keep))))
  _close(got, rwant)


def test_round_trip_and_parseval(rng):
  u = rng.standard_normal((64, 48))
  U = sp.from_numpy(u)
  _close(_g(sp.real(sp.fft.ifft2(sp.fft.fft2(U) * 0.5))), u * 0.5)
  _close(_g(sp.fft.irfft2(sp.fft.rfft2(U), s=u.shape)), u)
  F = sp.fft.fft2(U)
  energy = float(_g(sp.sum(sp.abs(F) ** 2))) / u.size
  np.testing.assert_allclose(energy, float((u * u).sum()), rtol=TOL)


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_cosine_transforms_all_types(kind, type):
  rng = np.random.default_rng(5)
  x = rng.standard_normal((6, 32))
  for norm in (None, "ortho", "forward"):
    for inv in ("", "i"):
      got = _g(getattr(sp.fft, inv + kind)(x, type=type, norm=norm))
      _close(got, getattr(sfft, inv + kind)(x, type=type, norm=norm))
      _close(got, _r(getattr(ref.fft, inv + kind)(x, type=type, norm=norm)))


def test_cosine_orthogonalize_axis_n_int_and_complex():
  rng = np.random.default_rng(6)
  x = rng.standard_normal((5, 24))
  for o in (True, False):
    _close(_g(sp.fft.dct(x, norm="ortho", orthogonalize=o)),
           sfft.dct(x, norm="ortho", orthogonalize=o))
  _close(_g(sp.fft.dct(x, n=32, axis=0)), sfft.dct(x, n=32, axis=0))
  _close(_g(sp.fft.dst(x, n=10, axis=-1)), sfft.dst(x, n=10, axis=-1))
  xi = rng.integers(-5, 5, (4, 16))
  _close(_g(sp.fft.dct(xi)), sfft.dct(xi))
  xc = x[:, :16] + 1j * x[:, 8:24]
  _close(_g(sp.fft.dct(xc, type=3)), sfft.dct(xc, type=3))
  _close(_g(sp.fft.idst(xc, type=4)), sfft.idst(xc, type=4))
  # float32 keeps float32 for every type, as scipy's does
  x32 = x.astype(np.float32)
  for t in (1, 2, 3, 4):
    got = _g(sp.fft.dct(x32, type=t))
    _close(got, sfft.dct(x32, type=t), TOL32)


def test_cosine_nd():
  rng = np.random.default_rng(7)
  x = rng.standard_normal((8, 12, 10))
  _close(_g(sp.fft.dctn(x)), sfft.dctn(x))
  _close(_g(sp.fft.idctn(x, norm="ortho")), sfft.idctn(x, norm="ortho"))
  _close(_g(sp.fft.dstn(x, type=3, axes=(0, 2))),
         sfft.dstn(x, type=3, axes=(0, 2)))
  got = _g(sp.fft.idstn(x, s=(8, 12), axes=(1, 2), norm="forward"))
  _close(got, sfft.idstn(x, s=(8, 12), axes=(1, 2), norm="forward"))
  _close(got, _r(ref.fft.idstn(x, s=(8, 12), axes=(1, 2), norm="forward")))
  _close(_g(sp.fft.idctn(_g(sp.fft.dctn(x)))), x)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hermitian_nd(norm):
  rng = np.random.default_rng(8)
  x = np.fft.rfftn(rng.standard_normal((6, 10, 16)))
  got = _g(sp.fft.hfftn(x, norm=norm))
  _close(got, sfft.hfftn(x, norm=norm))
  _close(got, _r(ref.fft.hfftn(x, norm=norm)))
  _close(_g(sp.fft.hfft2(x[0], norm=norm)), sfft.hfft2(x[0], norm=norm))
  r = rng.standard_normal((6, 10, 16))
  got = _g(sp.fft.ihfftn(r, norm=norm))
  _close(got, sfft.ihfftn(r, norm=norm))
  _close(got, _r(ref.fft.ihfftn(r, norm=norm)))
  _close(_g(sp.fft.ihfft2(r[0], norm=norm)), sfft.ihfft2(r[0], norm=norm))
  _close(_g(sp.fft.hfftn(x, s=(6, 10, 30), norm=norm)),
         sfft.hfftn(x, s=(6, 10, 30), norm=norm))


def test_fht_ifht():
  rng = np.random.default_rng(9)
  a = rng.standard_normal(64) * np.exp(-0.1 * np.arange(64))
  for mu, offset, bias in [(0.0, 0.0, 0.0), (2.0, 0.3, 0.0),
                           (0.5, 0.0, 0.1), (1.0, 0.2, -0.2)]:
    got = _g(sp.fft.fht(a, 0.05, mu, offset=offset, bias=bias))
    want = sfft.fht(a, 0.05, mu, offset=offset, bias=bias)
    _close(got, want, 1e-11)
    _close(got, _r(ref.fft.fht(a, 0.05, mu, offset=offset, bias=bias)),
           1e-11)
    back = _g(sp.fft.ifht(want, 0.05, mu, offset=offset, bias=bias))
    _close(back, sfft.ifht(want, 0.05, mu, offset=offset, bias=bias), 1e-11)
  ab = np.stack([a, a * 2.0])
  _close(_g(sp.fft.fht(ab, 0.05, 1.0)), sfft.fht(ab, 0.05, 1.0), 1e-11)
  assert np.isfinite(sp.fft.fhtoffset(0.05, 1.0, initial=0.1))
  assert sp.fft.next_fast_len(1000) >= 1000
  assert sp.fft.prev_fast_len(1000) <= 1000
  assert sp.fft.get_workers() >= 1


# -- Poisson's spectral solver --------------------------------------------

def test_poisson_spectral_solve_equals_the_reference(rng):
  n = 64
  f = rng.standard_normal((n, n))
  f -= f.mean()
  u = _g(poisson.solve(sp.from_numpy(f)))
  _close(u, _r(rpoisson.solve(ref.from_numpy(f))))
  # NumPy's spectral solve
  k = 2.0 * np.pi * np.fft.fftfreq(n)
  lam = 2.0 * np.cos(k[:, None]) + 2.0 * np.cos(k[None, :]) - 4.0
  inv = np.where(lam == 0, 0.0, 1.0 / np.where(lam == 0, 1.0, lam))
  _close(u, np.real(np.fft.ifft2(np.fft.fft2(f) * inv)))
  _close(_g(poisson.laplacian(sp.from_numpy(u))),
         _r(rpoisson.laplacian(ref.from_numpy(u))))


def test_poisson_residual_and_run():
  res, std = poisson.run(n=96)
  rres, rstd = rpoisson.run(n=96)
  assert res < 1e-12 and rres < 1e-12
  np.testing.assert_allclose(std, rstd, rtol=TOL)


def test_poisson_float32_residual(rng):
  """float32 f: a complex64 forward transform, the float64 symbol, a
  complex128 inverse; the residual through ``laplacian`` is the forward
  transform's rounding, within 64 · log2(N) · 2^-24 of max|f|."""
  n = 128
  f = rng.standard_normal((n, n))
  f -= f.mean()
  f32 = f.astype(np.float32)
  u = poisson.solve(sp.from_numpy(f32))
  res = float(_g(sp.max(sp.abs(poisson.laplacian(u) - sp.from_numpy(f32)))))
  assert res <= 64 * np.log2(n * n) * 2.0 ** -24 * np.abs(f32).max()
