"""Driven oscillator (port of ``spartan_tpu/examples/oscillator.py``):
simulate with the adaptive RK45 loop, denoise with the zero-phase filter
loops, recover the resonance with the device spectral estimator — the
integrate and signal surfaces composed into one workload.

Pipeline (everything after the host filter design runs on the device):
1. ``sp.integrate.solve_ivp`` — a damped oscillator integrated by the
   one-loop adaptive RK45 (t_eval filled in the loop).
2. additive noise (NumPy's ``default_rng(seed)``, the reference's draw),
   then ``sp.signal.filtfilt`` (two passes of the lfilter loop).
3. ``sp.signal.welch`` — the FFT PSD; the argmax bin recovers the natural
   frequency.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp


def simulate(omega: float = 2.0, zeta: float = 0.05, tf: float = 40.0,
             n_samples: int = 2048, rtol: float = 1e-8):
  """Integrate ``x'' + 2ζω x' + ω² x = 0`` from x(0)=1 — returns (t, x)
  with x sampled on a uniform grid by the in-loop Hermite fill."""
  t_eval = np.linspace(0.0, tf, n_samples)

  def f(t, y):
    return torch.stack([y[1], -2 * zeta * omega * y[1]
                        - omega * omega * y[0]])

  res = sp.integrate.solve_ivp(f, (0.0, tf), [1.0, 0.0], t_eval=t_eval,
                               rtol=rtol, atol=rtol * 1e-2)
  if not res.success:
    raise RuntimeError("integration failed")
  return t_eval, res.y[0]


def recover_frequency(t, x, noise: float = 0.3, seed: int = 0):
  """Noise + zero-phase low-pass + Welch PSD peak → f_natural (Hz)."""
  rng = np.random.default_rng(seed)
  fs = 1.0 / (t[1] - t[0])
  noisy = np.asarray(x) + noise * rng.standard_normal(np.shape(x))
  b, a = sp.signal.butter(4, 0.2)                 # host design
  clean = sp.signal.filtfilt(b, a, noisy)         # device loops
  f, P = sp.signal.welch(clean, fs=fs, nperseg=512)
  k = int(np.argmax(np.asarray(sp.lazify(P).glom())))
  return float(f[k])


def run(omega: float = 2.0, zeta: float = 0.05):
  """Full pipeline; returns (recovered_hz, expected_hz)."""
  t, x = simulate(omega=omega, zeta=zeta)
  got = recover_frequency(t, x)
  want = omega * np.sqrt(1 - zeta ** 2) / (2 * np.pi)
  return got, want
