"""``sp.signal`` of the port (``spartan_tpu_torch/signal.py``) against
scipy.signal and the reference's (``spartan_tpu/signal.py``) on its
8-device mesh: the reference's ``tests/test_signal.py`` on the port, each
device function held to scipy at that test's tolerance (atol 1e-12 for the
direct forms, 1e-10 for FFT and the recurrences, 1e-9 for filtfilt, the
derivative savgol and the chirps, 1e-7 for sosfiltfilt, 1e-8 for
decimate and czt) and to the reference at twice it (the reference called
once a case, its outputs concatenated into one expression).  Then the
batched lfilter along axis 0 and -1, the zi/zf round trip in both zi
layouts, the errors the port raises where jax's functions raise, the
structural maps on a mesh of four logical shards, the counted host calls
and the namespace against the reference's.  About 35 s serial on one core
(most of it the reference's compiles).
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import signal as signal_mod
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.map import MapExpr, is_structural

S, RS = sp.signal, ref.signal
rng = np.random.default_rng(21)
x = rng.normal(size=128)
x2 = rng.normal(size=(3, 100))
h9 = rng.normal(size=9)
A = rng.normal(size=(12, 14))
K = rng.normal(size=(3, 4))
y128 = rng.normal(size=128)
b4, a4 = ss.butter(4, 0.2)
sos4 = ss.butter(4, 0.2, output="sos")
tw = np.linspace(0, 2, 101)
tt = np.linspace(-1, 1, 51)
A10 = rng.normal(size=(10, 12))
tobs = np.sort(rng.uniform(0, 10, 60))
yobs = np.sin(2 * np.pi * 0.7 * tobs) + 0.1 * rng.normal(size=60)
freqs = np.linspace(0.1, 2.0, 40) * 2 * np.pi


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def g(e):
  if isinstance(e, tuple):
    return tuple(g(v) for v in e)
  return np.asarray(e.glom()) if hasattr(e, "glom") else np.asarray(e)


def ref_all(exprs):
  """The reference's exprs evaluated in one call, split back."""
  flat = [ref.lazify(e).ravel() for e in exprs]
  out = np.asarray(ref.concatenate(flat).glom())
  sizes = np.cumsum([0] + [int(np.prod(ref.lazify(e).shape)) for e in exprs])
  return [out[a:b] for a, b in zip(sizes[:-1], sizes[1:])]


# where the reference differs from scipy, the port is held to scipy alone
# and the reference to its failure (an exception, or "differs": its value
# is not within the tolerance of scipy's).  Its decimate(ftype='fir')
# designs 30 q + 1 taps where scipy designs 20 q + 1; zero-phase, it
# filters forward and backward (scipy: one resample_poly pass), which
# raises on a signal shorter than its 3 (30 q + 1) samples of padding
REFERENCE_DEFECTS = {"decimate_fir": ValueError,
                     "decimate_fir_causal": "differs"}


def _c(label, call, want, atol):
  return pytest.param(call, want, atol, REFERENCE_DEFECTS.get(label),
                      id=label)


# (call over the module, scipy's value, atol); the call gives one lazy Expr
CASES = [
    _c("convolve_full", lambda M: M.convolve(x, h9, mode="full"),
       lambda: ss.convolve(x, h9, mode="full"), 1e-12),
    _c("convolve_same", lambda M: M.convolve(x, h9, mode="same"),
       lambda: ss.convolve(x, h9, mode="same"), 1e-12),
    _c("convolve_valid", lambda M: M.convolve(x, h9, mode="valid"),
       lambda: ss.convolve(x, h9, mode="valid"), 1e-12),
    _c("convolve_swapped", lambda M: M.convolve(h9, x),
       lambda: ss.convolve(h9, x), 1e-12),
    _c("convolve_fft", lambda M: M.convolve(x, h9, method="fft"),
       lambda: ss.convolve(x, h9), 1e-10),
    _c("correlate_full", lambda M: M.correlate(x, h9, mode="full"),
       lambda: ss.correlate(x, h9, mode="full"), 1e-12),
    _c("correlate_same", lambda M: M.correlate(x, h9, mode="same"),
       lambda: ss.correlate(x, h9, mode="same"), 1e-12),
    _c("correlate_valid", lambda M: M.correlate(x, h9, mode="valid"),
       lambda: ss.correlate(x, h9, mode="valid"), 1e-12),
    _c("fftconvolve_full", lambda M: M.fftconvolve(x, h9),
       lambda: ss.fftconvolve(x, h9), 1e-10),
    _c("fftconvolve_same", lambda M: M.fftconvolve(x, h9, mode="same"),
       lambda: ss.fftconvolve(x, h9, mode="same"), 1e-10),
    _c("fftconvolve_valid", lambda M: M.fftconvolve(x, h9, mode="valid"),
       lambda: ss.fftconvolve(x, h9, mode="valid"), 1e-10),
    _c("fftconvolve_axes", lambda M: M.fftconvolve(x2, x2[:, :7], axes=1),
       lambda: ss.fftconvolve(x2, x2[:, :7], axes=1), 1e-10),
    _c("fftconvolve_2d", lambda M: M.fftconvolve(A, K, mode="same"),
       lambda: ss.fftconvolve(A, K, mode="same"), 1e-10),
    _c("oaconvolve", lambda M: M.oaconvolve(x, h9),
       lambda: ss.oaconvolve(x, h9), 1e-10),
    _c("convolve2d_full", lambda M: M.convolve2d(A, K),
       lambda: ss.convolve2d(A, K), 1e-12),
    _c("convolve2d_same", lambda M: M.convolve2d(A, K, mode="same"),
       lambda: ss.convolve2d(A, K, mode="same"), 1e-12),
    _c("correlate2d_valid", lambda M: M.correlate2d(A, K, mode="valid"),
       lambda: ss.correlate2d(A, K, mode="valid"), 1e-12),
    _c("correlate2d_full", lambda M: M.correlate2d(A, K),
       lambda: ss.correlate2d(A, K), 1e-12),
    _c("correlate2d_same", lambda M: M.correlate2d(A, K, mode="same"),
       lambda: ss.correlate2d(A, K, mode="same"), 1e-12),
    _c("convolve_3d", lambda M: M.convolve(A[None].repeat(3, 0),
                                           K[None].repeat(2, 0)),
       lambda: ss.convolve(A[None].repeat(3, 0), K[None].repeat(2, 0)),
       1e-12),
    _c("detrend_linear", lambda M: M.detrend(x),
       lambda: ss.detrend(x), 1e-12),
    _c("detrend_constant", lambda M: M.detrend(x2, axis=0, type="constant"),
       lambda: ss.detrend(x2, axis=0, type="constant"), 1e-12),
    _c("detrend_axis0", lambda M: M.detrend(x2, axis=0),
       lambda: ss.detrend(x2, axis=0), 1e-12),
    _c("lfilter_iir", lambda M: M.lfilter(b4, a4, x),
       lambda: ss.lfilter(b4, a4, x), 1e-10),
    _c("lfilter_fir", lambda M: M.lfilter(ss.firwin(11, 0.3), [1.0], x),
       lambda: ss.lfilter(ss.firwin(11, 0.3), [1.0], x), 1e-12),
    _c("lfilter_gain", lambda M: M.lfilter([2.0], [4.0], x),
       lambda: ss.lfilter([2.0], [4.0], x), 1e-12),
    _c("lfilter_axis_last", lambda M: M.lfilter(b4, a4, x2, axis=-1),
       lambda: ss.lfilter(b4, a4, x2, axis=-1), 1e-10),
    _c("lfilter_axis_0", lambda M: M.lfilter(b4, a4, x2.T, axis=0),
       lambda: ss.lfilter(b4, a4, x2.T, axis=0), 1e-10),
    _c("filtfilt", lambda M: M.filtfilt(*ss.butter(3, 0.25), x),
       lambda: ss.filtfilt(*ss.butter(3, 0.25), x), 1e-9),
    _c("filtfilt_axis1", lambda M: M.filtfilt(*ss.butter(3, 0.25), x2,
                                              axis=1),
       lambda: ss.filtfilt(*ss.butter(3, 0.25), x2, axis=1), 1e-9),
    _c("filtfilt_even", lambda M: M.filtfilt(b4, a4, x, padtype="even"),
       lambda: ss.filtfilt(b4, a4, x, padtype="even"), 1e-9),
    _c("filtfilt_constant", lambda M: M.filtfilt(b4, a4, x,
                                                 padtype="constant"),
       lambda: ss.filtfilt(b4, a4, x, padtype="constant"), 1e-9),
    _c("filtfilt_nopad", lambda M: M.filtfilt(b4, a4, x, padtype=None),
       lambda: ss.filtfilt(b4, a4, x, padtype=None), 1e-9),
    _c("sosfilt", lambda M: M.sosfilt(sos4, x),
       lambda: ss.sosfilt(sos4, x), 1e-10),
    _c("sosfilt_axis0", lambda M: M.sosfilt(sos4, x2.T, axis=0),
       lambda: ss.sosfilt(sos4, x2.T, axis=0), 1e-10),
    _c("sosfiltfilt", lambda M: M.sosfiltfilt(sos4, x),
       lambda: ss.sosfiltfilt(sos4, x), 1e-7),
    _c("sosfiltfilt_order16",
       lambda M: M.sosfiltfilt(ss.butter(16, 0.1, output="sos"), x),
       lambda: ss.sosfiltfilt(ss.butter(16, 0.1, output="sos"), x), 1e-9),
    _c("decimate_iir", lambda M: M.decimate(x, 4),
       lambda: ss.decimate(x, 4), 1e-8),
    _c("decimate_fir", lambda M: M.decimate(x, 3, ftype="fir"),
       lambda: ss.decimate(x, 3, ftype="fir"), 1e-12),
    _c("decimate_fir_causal", lambda M: M.decimate(x2, 3, ftype="fir",
                                                   axis=1, zero_phase=False),
       lambda: ss.decimate(x2, 3, ftype="fir", axis=1, zero_phase=False),
       1e-12),
    _c("decimate_causal", lambda M: M.decimate(x2, 2, axis=1,
                                               zero_phase=False),
       lambda: ss.decimate(x2, 2, axis=1, zero_phase=False), 1e-8),
    _c("welch", lambda M: M.welch(x, fs=10.0, nperseg=64)[1],
       lambda: ss.welch(x, fs=10.0, nperseg=64)[1], 1e-12),
    _c("welch_2d_axis0", lambda M: M.welch(x2.T, nperseg=32, axis=0)[1],
       lambda: ss.welch(x2.T, nperseg=32, axis=0)[1], 1e-12),
    _c("welch_linear_spectrum",
       lambda M: M.welch(x, nperseg=40, detrend="linear",
                         scaling="spectrum")[1],
       lambda: ss.welch(x, nperseg=40, detrend="linear",
                        scaling="spectrum")[1], 1e-12),
    _c("welch_oversized", lambda M: M.welch(x, nperseg=512)[1],
       lambda: ss.welch(x, nperseg=128)[1], 1e-12),
    _c("periodogram", lambda M: M.periodogram(x, fs=10.0)[1],
       lambda: ss.periodogram(x, fs=10.0)[1], 1e-12),
    _c("csd", lambda M: M.csd(x, y128, nperseg=64)[1],
       lambda: ss.csd(x, y128, nperseg=64)[1], 1e-12),
    _c("csd_twosided", lambda M: M.csd(x, y128, nperseg=64,
                                       return_onesided=False)[1],
       lambda: ss.csd(x, y128, nperseg=64, return_onesided=False)[1],
       1e-12),
    _c("coherence", lambda M: M.coherence(x, y128, nperseg=64)[1],
       lambda: ss.coherence(x, y128, nperseg=64)[1], 1e-10),
    _c("spectrogram", lambda M: M.spectrogram(x, fs=8.0, nperseg=32,
                                              noverlap=8)[2],
       lambda: ss.spectrogram(x, fs=8.0, nperseg=32, noverlap=8)[2], 1e-12),
    _c("stft", lambda M: M.stft(x, nperseg=32)[2],
       lambda: ss.stft(x, nperseg=32)[2], 1e-12),
    _c("stft_no_boundary", lambda M: M.stft(x, nperseg=32,
                                            boundary=None)[2],
       lambda: ss.stft(x, nperseg=32, boundary=None)[2], 1e-12),
    _c("istft", lambda M: M.istft(ss.stft(x, nperseg=32)[2], nperseg=32)[1],
       lambda: ss.istft(ss.stft(x, nperseg=32)[2], nperseg=32)[1], 1e-10),
    _c("hilbert", lambda M: M.hilbert(np.cos(2 * np.pi * 5 * tw)),
       lambda: ss.hilbert(np.cos(2 * np.pi * 5 * tw)), 1e-10),
    _c("hilbert_odd_N", lambda M: M.hilbert(x, N=131),
       lambda: ss.hilbert(x, N=131), 1e-10),
    _c("hilbert2", lambda M: M.hilbert2(A[:8, :8]),
       lambda: ss.hilbert2(A[:8, :8]), 1e-10),
    _c("resample_down", lambda M: M.resample(x, 64),
       lambda: ss.resample(x, 64), 1e-10),
    _c("resample_up", lambda M: M.resample(x, 200),
       lambda: ss.resample(x, 200), 1e-10),
    _c("resample_odd", lambda M: M.resample(x, 127),
       lambda: ss.resample(x, 127), 1e-10),
    _c("resample_odd_input", lambda M: M.resample(x[:127], 63),
       lambda: ss.resample(x[:127], 63), 1e-10),
    _c("resample_window", lambda M: M.resample(x, 64, window="hann"),
       lambda: ss.resample(x, 64, window="hann"), 1e-10),
    _c("upfirdn", lambda M: M.upfirdn(ss.firwin(21, 0.4), x, 3, 2),
       lambda: ss.upfirdn(ss.firwin(21, 0.4), x, 3, 2), 1e-12),
    _c("resample_poly_up", lambda M: M.resample_poly(x, 3, 2),
       lambda: ss.resample_poly(x, 3, 2), 1e-10),
    _c("resample_poly_down", lambda M: M.resample_poly(x, 2, 5),
       lambda: ss.resample_poly(x, 2, 5), 1e-10),
    _c("resample_poly_window",
       lambda M: M.resample_poly(x, 3, 2, window=ss.firwin(
           21, 1 / 3, window=("kaiser", 5.0))),
       lambda: ss.resample_poly(x, 3, 2, window=ss.firwin(
           21, 1 / 3, window=("kaiser", 5.0))), 1e-10),
    _c("savgol", lambda M: M.savgol_filter(x, 11, 3),
       lambda: ss.savgol_filter(x, 11, 3), 1e-10),
    _c("savgol_deriv", lambda M: M.savgol_filter(x, 11, 3, deriv=1,
                                                 delta=0.5),
       lambda: ss.savgol_filter(x, 11, 3, deriv=1, delta=0.5), 1e-9),
    _c("savgol_even", lambda M: M.savgol_filter(x, 10, 3),
       lambda: ss.savgol_filter(x, 10, 3), 1e-10),
    _c("wiener", lambda M: M.wiener(A10, 3),
       lambda: ss.wiener(A10, 3), 1e-10),
    _c("wiener_noise", lambda M: M.wiener(A10, (3, 5), noise=0.5),
       lambda: ss.wiener(A10, (3, 5), noise=0.5), 1e-10),
    _c("medfilt", lambda M: M.medfilt(x, 5),
       lambda: ss.medfilt(x, 5), 1e-12),
    _c("medfilt2d", lambda M: M.medfilt2d(A10, 3),
       lambda: ss.medfilt2d(A10, 3), 1e-12),
    _c("order_filter", lambda M: M.order_filter(A10, np.ones((3, 3), bool),
                                                2),
       lambda: ss.order_filter(A10, np.ones((3, 3), bool), 2), 1e-12),
    _c("order_filter_cross",
       lambda M: M.order_filter(A10, np.array([[0, 1, 0], [1, 1, 1],
                                               [0, 1, 0]]), 4),
       lambda: ss.order_filter(A10, np.array([[0, 1, 0], [1, 1, 1],
                                              [0, 1, 0]]), 4), 1e-12),
    _c("square", lambda M: M.square(tw * 7, 0.3),
       lambda: ss.square(tw * 7, 0.3), 1e-12),
    _c("sawtooth", lambda M: M.sawtooth(tw * 7, 0.7),
       lambda: ss.sawtooth(tw * 7, 0.7), 1e-12),
    _c("chirp_linear", lambda M: M.chirp(tw, 1.0, 2.0, 10.0),
       lambda: ss.chirp(tw, 1.0, 2.0, 10.0), 1e-9),
    _c("chirp_quadratic", lambda M: M.chirp(tw, 1.0, 2.0, 10.0,
                                            method="quadratic"),
       lambda: ss.chirp(tw, 1.0, 2.0, 10.0, method="quadratic"), 1e-9),
    _c("chirp_quadratic_vertex",
       lambda M: M.chirp(tw, 1.0, 2.0, 10.0, method="quadratic",
                         vertex_zero=False),
       lambda: ss.chirp(tw, 1.0, 2.0, 10.0, method="quadratic",
                        vertex_zero=False), 1e-9),
    _c("chirp_logarithmic", lambda M: M.chirp(tw, 1.0, 2.0, 10.0,
                                              method="logarithmic"),
       lambda: ss.chirp(tw, 1.0, 2.0, 10.0, method="logarithmic"), 1e-9),
    _c("chirp_hyperbolic", lambda M: M.chirp(tw, 1.0, 2.0, 10.0,
                                             method="hyperbolic"),
       lambda: ss.chirp(tw, 1.0, 2.0, 10.0, method="hyperbolic"), 1e-9),
    _c("gausspulse", lambda M: M.gausspulse(tt, fc=5),
       lambda: ss.gausspulse(tt, fc=5), 1e-12),
    _c("gausspulse_quad", lambda M: M.gausspulse(tt, fc=5, retquad=True,
                                                 retenv=True)[1],
       lambda: ss.gausspulse(tt, fc=5, retquad=True, retenv=True)[1],
       1e-12),
    _c("sweep_poly", lambda M: M.sweep_poly(tw, [0.05, -0.75, 2.0, 5.0]),
       lambda: ss.sweep_poly(tw, [0.05, -0.75, 2.0, 5.0]), 1e-9),
    _c("unit_impulse", lambda M: M.unit_impulse(7, "mid"),
       lambda: ss.unit_impulse(7, "mid"), 0.0),
    _c("unit_impulse_2d", lambda M: M.unit_impulse((3, 3), 1),
       lambda: ss.unit_impulse((3, 3), 1), 0.0),
    _c("lombscargle", lambda M: M.lombscargle(tobs, yobs, freqs),
       lambda: ss.lombscargle(tobs, yobs, freqs), 1e-10),
    _c("lombscargle_precenter", lambda M: M.lombscargle(
        tobs, yobs, freqs, precenter=True, normalize=True),
       lambda: ss.lombscargle(tobs, yobs - yobs.mean(), freqs,
                              normalize=True), 1e-10),
    _c("czt_dft", lambda M: M.czt(x, m=128),
       lambda: np.fft.fft(x), 1e-8),
    _c("czt", lambda M: M.czt(x, m=40, w=np.exp(-0.03j), a=0.9 + 0.1j),
       lambda: ss.czt(x, m=40, w=np.exp(-0.03j), a=0.9 + 0.1j), 1e-8),
    _c("zoom_fft", lambda M: M.zoom_fft(x, [0.1, 0.4], m=32, fs=1.0),
       lambda: ss.zoom_fft(x, [0.1, 0.4], m=32, fs=1.0), 1e-8),
    _c("gauss_spline", lambda M: M.gauss_spline(x, 3),
       lambda: ss.gauss_spline(x, 3), 1e-12),
    _c("vectorstrength", lambda M: M.vectorstrength(np.array(
        [0.1, 0.2, 0.3, 1.45]), 1.0)[0],
       lambda: ss.vectorstrength(np.array([0.1, 0.2, 0.3, 1.45]), 1.0)[0],
       1e-12),
    _c("vectorstrength_periods", lambda M: M.vectorstrength(np.array(
        [0.1, 0.2, 0.3, 1.45]), np.array([1.0, 0.7]))[1],
       lambda: ss.vectorstrength(np.array([0.1, 0.2, 0.3, 1.45]),
                                 np.array([1.0, 0.7]))[1], 1e-12),
]


@pytest.mark.parametrize("call,want,atol,defect", CASES)
def test_device_function_against_scipy_and_the_reference(call, want, atol,
                                                         defect):
  import warnings
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    out = call(S)
    assert isinstance(out, Expr), "a device function stays lazy"
    got = g(out)
    np.testing.assert_allclose(got, want(), rtol=0, atol=atol)
    if defect == "differs":
      theirs, = ref_all([call(RS)])
      assert not np.allclose(theirs, np.ravel(want()), rtol=0, atol=atol)
      return
    if defect is not None:
      with pytest.raises(defect):
        ref_all([call(RS)])
      return
    theirs, = ref_all([call(RS)])
  np.testing.assert_allclose(got.ravel(), theirs, rtol=0,
                             atol=2 * atol + 1e-15)


def test_frequency_and_time_grids():
  for ours, want in ((S.welch(x, fs=10.0, nperseg=64),
                      ss.welch(x, fs=10.0, nperseg=64)),
                     (S.csd(x, y128, nperseg=64, return_onesided=False),
                      ss.csd(x, y128, nperseg=64, return_onesided=False)),
                     (S.periodogram(x, fs=10.0), ss.periodogram(x, fs=10.0))):
    np.testing.assert_allclose(ours[0], want[0])
    assert g(ours[1]).shape == want[1].shape
  for kw in ({"nperseg": 32}, {"nperseg": 33}, {"nperseg": 32,
                                                "boundary": None}):
    f, t, Z = S.stft(x, **kw)
    fw, tw_, Zw = ss.stft(x, **kw)
    np.testing.assert_allclose(f, fw)
    np.testing.assert_allclose(t, tw_)
    assert g(Z).shape == Zw.shape and g(Z).dtype == np.complex128
  f, t, _ = S.spectrogram(x, fs=8.0, nperseg=32, noverlap=8)
  fw, tw_, _ = ss.spectrogram(x, fs=8.0, nperseg=32, noverlap=8)
  np.testing.assert_allclose(f, fw)
  np.testing.assert_allclose(t, tw_)
  tr, xr = S.istft(ss.stft(x, nperseg=32)[2], nperseg=32)
  np.testing.assert_allclose(tr, ss.istft(ss.stft(x, nperseg=32)[2],
                                          nperseg=32)[0])
  np.testing.assert_allclose(g(xr)[:128], x, atol=1e-10)
  y, new_t = S.resample(x, 64, t=np.arange(128) * 0.5)
  np.testing.assert_allclose(new_t, ss.resample(x, 64,
                                                t=np.arange(128) * 0.5)[1])
  np.testing.assert_array_equal(S.correlation_lags(10, 5, "full"),
                                ss.correlation_lags(10, 5, "full"))


def test_lfilter_zi_round_trip():
  """zi in both layouts: a vector of k states, and x's layout with k
  states on the filter axis (moved to the front before flattening)."""
  zi = ss.lfilter_zi(b4, a4) * x[0]
  y_ours, zf_ours = S.lfilter(b4, a4, x, zi=zi)
  y_want, zf_want = ss.lfilter(b4, a4, x, zi=zi)
  np.testing.assert_allclose(g(y_ours), y_want, atol=1e-10)
  np.testing.assert_allclose(g(zf_ours), zf_want, atol=1e-10)
  b3, a3 = ss.butter(3, 0.2)
  X = rng.normal(size=(3, 50))
  zi3 = np.repeat(ss.lfilter_zi(b3, a3)[None, :], 3, axis=0) * X[:, :1]
  y_o, zf_o = S.lfilter(b3, a3, X, axis=-1, zi=zi3)
  y_w, zf_w = ss.lfilter(b3, a3, X, axis=-1, zi=zi3)
  np.testing.assert_allclose(g(y_o), y_w, atol=1e-10)
  np.testing.assert_allclose(g(zf_o), zf_w, atol=1e-10)
  y_o, zf_o = S.lfilter(b3, a3, X.T, axis=0, zi=zi3.T)
  y_w, zf_w = ss.lfilter(b3, a3, X.T, axis=0, zi=zi3.T)
  np.testing.assert_allclose(g(y_o), y_w, atol=1e-10)
  np.testing.assert_allclose(g(zf_o), zf_w, atol=1e-10)
  # the final state continues the filter: two halves equal the whole
  y1, z1 = S.lfilter(b4, a4, x[:60], zi=np.zeros(4))
  y2, _ = S.lfilter(b4, a4, x[60:], zi=g(z1))
  np.testing.assert_allclose(np.concatenate([g(y1), g(y2)]),
                             ss.lfilter(b4, a4, x), atol=1e-10)
  theirs = RS.lfilter(b3, a3, X, axis=-1, zi=zi3)
  wy, wz = ref_all(list(theirs))
  y_o, zf_o = S.lfilter(b3, a3, X, axis=-1, zi=zi3)
  np.testing.assert_allclose(g(y_o).ravel(), wy, atol=2e-10)
  np.testing.assert_allclose(g(zf_o).ravel(), wz, atol=2e-10)


def test_float32_and_int_signals():
  got = g(S.lfilter(b4, a4, x.astype(np.float32)))
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, ss.lfilter(b4, a4, x), atol=1e-5)
  got = g(S.sosfiltfilt(sos4, x.astype(np.float32)))
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, ss.sosfiltfilt(sos4, x), atol=1e-5)
  ints = np.arange(40) % 7
  got = g(S.lfilter(b4, a4, ints))
  assert got.dtype == np.float64
  np.testing.assert_allclose(got, ss.lfilter(b4, a4, ints), atol=1e-10)
  assert g(S.welch(x.astype(np.float32), nperseg=32)[1]).dtype == np.float32
  assert g(S.hilbert(x.astype(np.float32))).dtype == np.complex64
  assert g(S.czt(x, m=64)).dtype == np.complex128
  np.testing.assert_allclose(g(S.convolve(ints, ints[:5])),
                             ss.convolve(ints, ints[:5]), atol=1e-12)


def test_errors_where_jax_raises():
  """Where jax.scipy.signal raises, the port raises the same error, and
  the reference's wrapper too (at the call or its evaluation)."""
  cases = [
      (NotImplementedError,
       lambda M: M.convolve2d(A, K, boundary="wrap")),
      (NotImplementedError,
       lambda M: M.convolve2d(A, K, fillvalue=1.0)),
      (NotImplementedError,
       lambda M: M.correlate2d(A, K, boundary="symm")),
      (NotImplementedError,
       lambda M: M.correlate2d(A, K, fillvalue=2.0)),
      (NotImplementedError, lambda M: M.welch(x, average="median")),
      (NotImplementedError, lambda M: M.csd(x, y128, average="median")),
      (NotImplementedError,
       lambda M: M.sosfilt(sos4, x, zi=np.zeros((2, 2)))),
      (NotImplementedError, lambda M: M.detrend(x, bp=[10, 40])),
      (NotImplementedError, lambda M: M.spectrogram(x, mode="magnitude")),
      (ValueError, lambda M: M.convolve2d(x, h9)),
      (ValueError, lambda M: M.convolve(A, K.T[:1].repeat(20, 0))),
      (ValueError, lambda M: M.lfilter(b4, [0.0, 1.0], x)),
      (ValueError, lambda M: M.filtfilt(b4, a4, x[:15])),
      (ValueError, lambda M: M.savgol_filter(x[:8], 11, 3)),
  ]
  for err, call in cases:
    with pytest.raises(err):
      g(call(S))
    with pytest.raises(err):
      g(call(RS))


def test_recurrence_launch_count_shape():
  """The recurrence runs as the loop over samples, no host read: on meta
  tensors (shape inference) it returns at once."""
  e = S.lfilter(b4, a4, rng.normal(size=(5, 3000)), axis=-1)
  assert e.shape == (5, 3000)
  e = S.sosfiltfilt(ss.butter(8, 0.1, output="sos"),
                    rng.normal(size=(3000, 2)), axis=0)
  assert e.shape == (3000, 2)


_STRUCTURAL = [
    ("lfilter", lambda X: S.lfilter(b4, a4, X, axis=0)),
    ("filtfilt", lambda X: S.filtfilt(b4, a4, X, axis=0)),
    ("sosfilt", lambda X: S.sosfilt(sos4, X, axis=0)),
    ("detrend", lambda X: S.detrend(X, axis=0)),
    ("convolve", lambda X: S.convolve(X, np.ones((3, 1)) / 3, mode="same")),
    ("fftconvolve", lambda X: S.fftconvolve(X, np.ones((3, 1)) / 3,
                                            mode="same")),
    ("medfilt", lambda X: S.medfilt(X, (3, 1))),
    ("savgol", lambda X: S.savgol_filter(X, 5, 2, axis=0)),
    ("wiener", lambda X: S.wiener(X, (3, 1))),
    ("hilbert_abs", lambda X: S.hilbert(X, axis=0)),
    ("welch", lambda X: S.welch(X, nperseg=16, axis=0)[1]),
    ("resample", lambda X: S.resample(X, 40)),
]


@pytest.mark.parametrize("label,fn", _STRUCTURAL,
                         ids=[c[0] for c in _STRUCTURAL])
def test_structural_maps_on_four_shards(label, fn):
  """Each kernel that works along an axis is a structural map: on a mesh of
  four logical shards, ``f(X) + ones`` of the result's shape equals the
  value + 1."""
  sp.initialize(["--device=cpu", "--mesh_shape=4"])
  try:
    X = rng.normal(size=(40, 4))
    e = fn(sp.from_numpy(X))
    assert isinstance(e, MapExpr) and is_structural(e.op), label
    want = g(fn(X))
    out = g(e + sp.ones(want.shape))
    np.testing.assert_allclose(out, want + 1, rtol=1e-12, atol=1e-12)
  finally:
    sp.initialize(["--device=cpu", "--mesh_shape="])


def test_host_calls_are_counted_and_reexports_are_scipys():
  before = fio.counts["host_runs"]
  np.testing.assert_allclose(S.savgol_coeffs(7, 2),
                             ss.savgol_coeffs(7, 2))
  S.correlation_lags(10, 5)
  assert S.gausspulse("cutoff", fc=5) == ss.gausspulse("cutoff", fc=5)
  assert fio.counts["host_runs"] - before == 3
  for name in signal_mod._REEXPORT:
    assert getattr(S, name) is getattr(ss, name), name
  b, a = S.butter(4, 0.2)
  np.testing.assert_allclose(b, ss.butter(4, 0.2)[0])
  peaks, _ = S.find_peaks(np.sin(np.linspace(0, 20, 200)))
  assert len(peaks) == 3


def test_no_device_function_falls_back_to_scipy(monkeypatch):
  """The device functions compute with scipy.signal's functions hidden,
  but for the coefficient designs they make for themselves."""
  class Designs:
    def __getattr__(self, name):
      if name in ("lfilter_zi", "sosfilt_zi", "get_window", "firwin",
                  "cheby1", "savgol_coeffs", "check_NOLA"):
        return getattr(ss, name)
      raise AssertionError(f"scipy.signal.{name} was called")
  monkeypatch.setattr(signal_mod, "_ss", Designs())
  before = fio.counts["host_runs"]
  for p in CASES:
    call = p.values[0]
    if "lags" not in p.id:
      g(call(S))
  assert fio.counts["host_runs"] == before


def test_namespace_matches_the_reference():
  assert S.__all__ == RS.__all__
  assert len(S.__all__) == 157
  assert signal_mod._REEXPORT == RS._REEXPORT
  for name in S.__all__:
    assert hasattr(S, name), name


def test_designs_of_any_strides(monkeypatch):
  """scipy's designs may come back as reversed views (negative strides,
  which torch refuses): filtfilt and sosfiltfilt take lfilter_zi's and
  sosfilt_zi's states and welch a window in any layout."""
  class Reversed:
    def __getattr__(self, name):
      fn = getattr(ss, name)
      if name not in ("lfilter_zi", "sosfilt_zi", "get_window"):
        return fn

      def reversed_view(*a, **k):
        out = np.ascontiguousarray(fn(*a, **k)[::-1])[::-1]
        assert any(st < 0 for st in out.strides)
        return out
      return reversed_view
  monkeypatch.setattr(signal_mod, "_ss", Reversed())
  np.testing.assert_allclose(g(S.filtfilt(b4, a4, x)),
                             ss.filtfilt(b4, a4, x), atol=1e-9)
  np.testing.assert_allclose(g(S.sosfiltfilt(sos4, x)),
                             ss.sosfiltfilt(sos4, x), atol=1e-7)
  np.testing.assert_allclose(g(S.welch(x, nperseg=64)[1]),
                             ss.welch(x, nperseg=64)[1], atol=1e-12)
  np.testing.assert_allclose(g(S.lfilter(b4[::-1][::-1], a4[::-1][::-1],
                                         x[::-1])),
                             ss.lfilter(b4, a4, x[::-1]), atol=1e-10)
