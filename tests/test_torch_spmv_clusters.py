"""K3a's on-chip form, on the CPU.

* K3a's sum order (``csrc/spmv_ell.cu``): a row's entries in pieces of 4
  (the last piece the k % 4 left over), lane l of a row's group of G taking
  pieces l, l + G, ... and adding their products in entry order, then a
  shuffle tree, offset G/2 first; the same order whether a piece is loaded
  16 bytes or 4 bytes at a time.  Emulated in numpy: in float32 (the
  kernel's rounded products and adds) against the reference's
  ``spmv(interpret=True)`` at 1e-5 of max|y| (float32 sums of the same
  products in another order), and in float64 against ``A @ x`` at 1e-12 of
  max|y|.  The emulation in float32 is the kernel's result bit for bit;
  tests/test_torch_cuda.py holds the kernel to it on the card.
* K3a's form (``spmv.ell_on_chip``, ``spmv.ell_form``): on chip up to
  ``ELL_MAX_X`` floats of x, 16-byte loads where k % 4 == 0 and cols and
  vals start on 16 bytes, else 4-byte loads (counted in
  ``ell_4byte_launches``), through L1 past it (counted in
  ``ell_through_l1_launches``), with ``build.launch`` stubbed; a misaligned
  x copied to a 16-byte boundary; every band takes the whole matrix's form.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_tpu.backend.kernels import spmv_pallas as sk

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels import spmv as KS

@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


# -- K3a --------------------------------------------------------------------------

def k3a_emulated(cols, vals, x, group, dtype):
  """K3a's on-chip result in ``dtype``, summed in the kernel's order."""
  n, k = cols.shape
  prods = vals.astype(dtype) * x.astype(dtype)[cols]
  lanes = np.zeros((n, group), dtype)
  for lane in range(group):
    for j in range(lane, -(-k // 4), group):
      for e in range(4 * j, min(4 * j + 4, k)):
        lanes[:, lane] = lanes[:, lane] + prods[:, e]
  o = group // 2
  while o:
    lanes[:, :o] = lanes[:, :o] + lanes[:, o:2 * o]
    o //= 2
  return lanes[:, 0]


def _ell(n, k, m, seed):
  rng = np.random.default_rng(seed)
  cols = rng.integers(0, m, (n, k)).astype(np.int32)
  vals = rng.standard_normal((n, k)).astype(np.float32)
  vals[:, k // 2:][rng.random((n, k - k // 2)) < 0.5] = 0  # pad-like zeros
  cols[vals == 0] = 0
  x = rng.standard_normal(m).astype(np.float32)
  return cols, vals, x


# (n, k, m): k = 36 (urand 32768's, 16-byte loads), k = 35 and 37 (4-byte
# loads, a last piece of 3 and of 1), k = 17, a row of more than 32 pieces,
# tiny ones
K3A_SHAPES = [(300, 36, 2000), (300, 35, 2000), (300, 37, 2000),
              (300, 17, 200), (40, 260, 4096), (13, 3, 20), (9, 1, 5)]


@pytest.mark.parametrize("n, k, m", K3A_SHAPES, ids=str)
def test_k3a_order_matches_the_reference_and_a_float64_product(n, k, m):
  cols, vals, x = _ell(n, k, m, n + k)
  vec = 4 if k % 4 == 0 else 1
  group = KS.group_size(-(-k // 4))
  assert KS.ell_form(torch.from_numpy(cols), torch.from_numpy(vals), m) == (
      1, vec, group)
  got = k3a_emulated(cols, vals, x, group, np.float32)
  want = np.asarray(sk.spmv(jnp.asarray(cols), jnp.asarray(vals),
                            jnp.asarray(x), interpret=True))
  scale = np.abs(want).max()
  assert np.abs(got - want).max() <= 1e-5 * scale
  exact = (vals.astype(np.float64) * x.astype(np.float64)[cols]).sum(1)
  got64 = k3a_emulated(cols, vals, x, group, np.float64)
  assert np.abs(got64 - exact).max() <= 1e-12 * np.abs(exact).max()


def test_k3a_pad_entries_carry_a_nonfinite_x0():
  cols, vals, x = _ell(50, 36, 300, 1)
  x[0] = np.inf
  with np.errstate(invalid="ignore"):
    got = k3a_emulated(cols, vals, x, 16, np.float32)
  want = np.asarray(sk.spmv(jnp.asarray(cols), jnp.asarray(vals),
                            jnp.asarray(x), interpret=True))
  padded = (vals == 0).any(1)
  assert padded.any()
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  assert np.isnan(got[padded]).all()


def test_k3a_form_follows_x_and_the_operands_alignment():
  n, k = 64, 36
  cols = torch.zeros((n, k), dtype=torch.int32)
  vals = torch.zeros((n, k))
  assert not KS.ell_on_chip(0) and KS.ell_on_chip(1)
  assert KS.ell_on_chip(KS.ELL_MAX_X) and not KS.ell_on_chip(KS.ELL_MAX_X + 1)
  assert KS.ell_form(cols, vals, 300) == (1, 4, 16)
  spare = torch.zeros(n * k + 1)
  # the same pieces and lanes, loaded 4 bytes at a time
  assert KS.ell_form(cols, spare[1:].view(n, k), 300) == (1, 1, 16)
  odd = torch.zeros((n, 17), dtype=torch.int32)
  assert KS.ell_form(odd, torch.zeros((n, 17)), 300) == (1, 1, 8)
  assert KS.ell_form(cols, vals, KS.ELL_MAX_X + 1) == (0, 1, 32)


@pytest.mark.parametrize("m, k, through_l1", [(300, 36, False),
                                              (300, 35, False),
                                              (KS.ELL_MAX_X + 1, 36, True)],
                         ids=str)
def test_k3a_launch_counts_the_through_l1_form(m, k, through_l1,
                                               monkeypatch):
  n, p = 700, 8
  cols, vals, x = (torch.from_numpy(a) for a in _ell(n, k, m, 3))
  xs = torch.cat([torch.zeros(1), x])
  x_view = xs[1:]  # off a 16-byte boundary
  y = torch.empty(n)
  calls = []

  def launch(name, device, table, count, x_ptr, m_, k_, group, vec, on_chip):
    calls.append((count, x_ptr, m_, k_, group, vec, on_chip))
    rows = (ctypes.c_int64 * (4 * count)).from_address(table)
    for b in range(count):
      c, v, yy, rn = rows[4 * b:4 * b + 4]
      r0 = (c - cols.data_ptr()) // (4 * k)
      y[r0:r0 + rn] = KS.spmv_ell_plain(cols[r0:r0 + rn], vals[r0:r0 + rn],
                                        x)

  monkeypatch.setattr(build, "launch", launch)
  KS.reset_counts()
  bands = KS.ell_bands(n, p)
  assert KS._launch_bands(cols, vals, x_view, y, bands) == 1
  assert KS.counts["ell_through_l1_launches"] == int(through_l1)
  assert KS.counts["ell_4byte_launches"] == int(k % 4 != 0 and
                                                not through_l1)
  (count, x_ptr, m_, k_, group, vec, on_chip), = calls
  assert (count, m_, k_) == (len(bands), m, k)
  assert (on_chip, vec, group) == KS.ell_form(cols, vals, m)
  if through_l1:
    assert x_ptr == x_view.data_ptr()
  else:
    assert x_ptr % 16 == 0 and x_ptr != x_view.data_ptr()
  assert torch.equal(y, KS.spmv_ell_plain(cols, vals, x))


@pytest.mark.parametrize("k", [36, 35], ids=str)
def test_k3a_order_does_not_follow_the_operands_alignment(k):
  """The same matrix in storage off a 16-byte boundary takes 4-byte loads
  of the same pieces at the same lanes: the same form but for ``vec``."""
  n, m = 50, 300
  cols, vals, _ = (torch.from_numpy(a) for a in _ell(n, k, m, 11))
  spare_c = torch.zeros(n * k + 1, dtype=torch.int32)
  spare_v = torch.zeros(n * k + 1)
  off_c, off_v = spare_c[1:].view(n, k), spare_v[1:].view(n, k)
  off_c.copy_(cols)
  off_v.copy_(vals)
  on_chip, vec, group = KS.ell_form(cols, vals, m)
  assert KS.ell_form(off_c, off_v, m) == (on_chip, 1, group)
  assert vec == (4 if k % 4 == 0 else 1)
