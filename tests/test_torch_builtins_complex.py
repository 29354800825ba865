"""``convolve``, ``correlate`` and ``interp`` of complex arrays against
NumPy and the reference on a one-device mesh: on its 8-device CPU mesh
the reference's ``convolve``/``correlate`` of some shapes (a length 9
with 4 taps in ``valid`` mode, two lengths 6 in ``same`` mode) come out
4 times NumPy's, real or complex (ROADMAP, reference defects).

``correlate`` conjugates its second operand, as NumPy's does, and a
shorter first operand is swapped with the second, correlated and the
result reversed; both compute a complex product as four real
correlations (``F.conv1d``).  Tolerances: complex128 at 1e-13 of the
largest |value| (the real and imaginary sums in another order), complex64
at 2^-20 of it (float32 sums of a few terms).  A complex ``interp``
interpolates each part as NumPy's complex loop does (the slope by the
reciprocal of the step) and is held to NumPy exactly, to the reference at
1e-12 relative.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.core import mesh as ref_mesh

import spartan_tpu_torch as sp


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(19)


def _one_device():
  import jax
  return ref.with_mesh(ref_mesh.make_mesh(devices=jax.devices()[:1]))


def _glom(x):
  return np.asarray(x.glom())


def _complex(rng, n, dtype=np.complex128):
  return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


def _close(got, want, dtype):
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  assert got.shape == want.shape, (got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1.0)
  tol = 1e-13 if dtype == np.complex128 else 2.0 ** -20
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


PAIRS = {"long_short": (9, 4), "short_long": (4, 9), "equal": (6, 6),
         "even_taps": (11, 2), "one": (5, 1)}
OPERANDS = {"both_complex": (np.complex128, np.complex128),
            "complex64": (np.complex64, np.complex64),
            "real_second": (np.complex128, np.float64),
            "real_first": (np.float32, np.complex64)}


def _operand(rng, n, dtype):
  if np.dtype(dtype).kind == "c":
    return _complex(rng, n, dtype)
  return rng.standard_normal(n).astype(dtype)


@pytest.mark.parametrize("operands", sorted(OPERANDS))
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("name", ["convolve", "correlate"])
def test_complex_convolve_and_correlate(name, mode, pair, operands):
  la, lv = PAIRS[pair]
  da, dv = OPERANDS[operands]
  rng = np.random.default_rng(19)
  a, v = _operand(rng, la, da), _operand(rng, lv, dv)
  got = _glom(getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(v), mode))
  want = getattr(np, name)(a, v, mode)
  _close(got, want, want.dtype)
  with _one_device():
    r = _glom(getattr(ref, name)(ref.from_numpy(a), ref.from_numpy(v),
                                 mode))
  _close(got, r.astype(want.dtype), want.dtype)


def test_the_references_convolve_on_eight_devices_scales_some_shapes():
  a, v = np.arange(1.0, 10.0), np.ones(4)
  want = np.convolve(a, v, "valid")
  np.testing.assert_array_equal(_glom(sp.convolve(a, v, "valid")), want)
  r8 = _glom(ref.convolve(ref.from_numpy(a), ref.from_numpy(v), "valid"))
  np.testing.assert_array_equal(r8, 4 * want)
  with _one_device():
    r1 = _glom(ref.convolve(ref.from_numpy(a), ref.from_numpy(v), "valid"))
  np.testing.assert_array_equal(r1, want)


def test_correlate_conjugates_its_second_operand():
  a, v = np.array([1j, 2.0, 0.0]), np.array([1j])
  np.testing.assert_array_equal(_glom(sp.correlate(a, v)), [1, -2j, 0])
  np.testing.assert_array_equal(_glom(sp.correlate(v, a, "full")),
                                np.correlate(v, a, "full"))
  np.testing.assert_array_equal(_glom(sp.convolve(a, v)), [-1, 2j, 0])


XP = np.sort(RNG.uniform(-2, 2, 40))
XQ = np.concatenate([RNG.uniform(-2.5, 2.5, 300), XP[::5],
                     [np.nan, np.inf, -np.inf]])


@pytest.mark.parametrize("ends", [(None, None), (-1 + 2j, 3.5), (0.5, None)],
                         ids=str)
@pytest.mark.parametrize("fp", ["complex128", "complex64", "special"])
def test_complex_interp(fp, ends):
  f = _complex(np.random.default_rng(20), 40,
               np.complex64 if fp == "complex64" else np.complex128)
  if fp == "special":
    f[3], f[10], f[11] = np.inf + 1j, np.nan, complex(2.0, np.nan)
  got = _glom(sp.interp(sp.from_numpy(XQ), sp.from_numpy(XP),
                        sp.from_numpy(f), *ends))
  want = np.interp(XQ, XP, f, *ends)
  assert got.dtype == want.dtype == np.complex128
  np.testing.assert_array_equal(got, want)
  if fp == "special":
    return  # NumPy's NaN from one side tried from the other; jnp's is not
  with _one_device():
    r = _glom(ref.interp(ref.from_numpy(XQ), ref.from_numpy(XP),
                         ref.from_numpy(f), *ends))
  fin = np.isfinite(XQ)
  np.testing.assert_allclose(got[fin], r[fin], rtol=1e-12,
                             atol=1e-6 if fp == "complex64" else 1e-12)
