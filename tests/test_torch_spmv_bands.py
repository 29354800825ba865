"""K3a sharded's band table (``spmv.ell_bands``, ``spmv.band_table``) and
K3a's launch over it, and K3d's CSR band table (``spmv.csr_bands``,
``spmv.csr_band_table``) and K3b's launch over it, on the CPU.

* The bands follow the boundaries the port pins down for the sharded ELL:
  shard d owns rows ``[min(d·ceil(n/p), n), min((d+1)·ceil(n/p), n))``,
  nothing padded, and a shard past the last row has no entry.
* The table's addresses and row counts, and the launches in chunks of
  ``MAX_BANDS``, through the card routes' launcher with ``build.launch``
  stubbed: the stub reads the table back and runs each band's rows
  through the plain version, so the result must equal ``spmv_ell``'s bit
  for bit (each row is summed alone, in one order).
* The entry point against the reference's ``sharded_onehot_spmv`` in
  interpret mode on its virtual CPU devices at p = 3 and 4 and with fewer
  rows than shards, at 1e-5 of max|y| (the reference splits x into bf16
  hi/lo halves, tests/test_torch_sharded.py), and bit-equal to ``spmv_ell``.
* K3d's table: each non-empty shard's band of a sharded CSR pack (views of
  the pack's rebased indptr, indices and data, and its rows of y), its
  addresses and row counts, chunks of ``MAX_BANDS`` with ``build.launch``
  stubbed as above, and a result bit-equal to ``spmv_csr``'s at p = 2, 3,
  4 and 8, with fewer rows than shards and with more than 64 bands;
  ``spmv_csr`` launches a table of one band.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

from spartan_tpu.backend.kernels import spmv_pallas as ref_spmv
from spartan_tpu.core import mesh as ref_mesh

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels import spmv as KS


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _pinned(n, p):
  """Every shard's rows as the port pins them, empty shards included."""
  band = -(-n // p)
  return [(min(d * band, n), min((d + 1) * band, n)) for d in range(p)]


@pytest.mark.parametrize("p", [1, 2, 3, 4, 7, 8, 64, 65, 200])
@pytest.mark.parametrize("n", [1, 2, 5, 8, 63, 700, 1000, 32768])
def test_ell_bands_follow_the_pinned_boundaries(n, p):
  bands = KS.ell_bands(n, p)
  pinned = _pinned(n, p)
  assert bands == [b for b in pinned if b[1] > b[0]]
  # the non-empty shards come first and tile [0, n) in order
  assert bands == pinned[:len(bands)]
  assert all(r0 == r1 == n for r0, r1 in pinned[len(bands):])
  assert bands[0][0] == 0 and bands[-1][1] == n
  assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
  assert len(bands) == min(p, -(-n // -(-n // p)))


def _ell(n, m=40, k_density=0.2, seed=0):
  A = ss.random(n, m, density=k_density, format="csr", dtype=np.float32,
                random_state=np.random.RandomState(seed + n))
  return sps.from_scipy(A)


def test_band_table_holds_each_bands_addresses_and_rows():
  S = _ell(50)
  cols, vals = S.cols.contiguous(), S.vals.contiguous()
  k = cols.shape[1]
  y = torch.empty(50, dtype=torch.float32)
  bands = KS.ell_bands(50, 8)  # 7 rows a band, the last 1
  table = KS.band_table(cols, vals, y, bands)
  assert len(table) == len(bands) == 8
  for (r0, r1), (c, v, yy, rows) in zip(bands, table):
    assert c == cols[r0:].data_ptr() == cols.data_ptr() + 4 * r0 * k
    assert v == vals[r0:].data_ptr()
    assert yy == y[r0:].data_ptr()
    assert rows == r1 - r0 >= 1
  assert [t[3] for t in table] == [7] * 7 + [1]


class _Launches:
  """``build.launch`` for K3a's entry point on CPU tensors: reads the
  table back and runs each band's rows through the plain version."""

  def __init__(self, cols, vals, y):
    self.cols, self.vals, self.y = cols, vals, y
    self.calls = []

  def __call__(self, name, device, table, count, x_ptr, m, k, group, vec,
               on_chip):
    assert name == "spmv_ell" and 1 <= count <= KS.MAX_BANDS
    x = self.x
    assert k == self.cols.shape[1] and m == x.shape[0]
    assert (on_chip, vec, group) == KS.ell_form(self.cols, self.vals, m)
    rows = (ctypes.c_int64 * (4 * count)).from_address(table)
    assert x_ptr == x.data_ptr()
    self.calls.append(count)
    for b in range(count):
      c, v, yy, n = rows[4 * b:4 * b + 4]
      r0 = (c - self.cols.data_ptr()) // (4 * k)
      assert c == self.cols.data_ptr() + 4 * r0 * k
      assert v == self.vals.data_ptr() + 4 * r0 * k
      assert yy == self.y.data_ptr() + 4 * r0
      self.y[r0:r0 + n] = KS.spmv_ell_plain(self.cols[r0:r0 + n],
                                            self.vals[r0:r0 + n], x)


@pytest.mark.parametrize("n, p", [(700, 1), (700, 3), (700, 8), (700, 64),
                                  (700, 65), (1000, 200), (5, 8), (3, 65)],
                         ids=str)
def test_banded_route_launches_once_for_every_64_bands(n, p, monkeypatch,
                                                       rng):
  S = _ell(n)
  x = torch.as_tensor(rng.standard_normal(40).astype(np.float32))
  cols, vals = S.cols.contiguous(), S.vals.float().contiguous()
  y = torch.empty(n, dtype=torch.float32)
  stub = _Launches(cols, vals, y)
  stub.x = x
  monkeypatch.setattr(build, "launch", stub)
  bands = KS.ell_bands(n, p)
  chunks = -(-len(bands) // KS.MAX_BANDS)
  assert KS._launch_bands(cols, vals, x, y, bands) == chunks
  assert stub.calls == [min(KS.MAX_BANDS, len(bands) - lo)
                        for lo in range(0, len(bands), KS.MAX_BANDS)]
  assert torch.equal(y, KS.spmv_ell(cols, vals, x))


def _ref_mesh(p):
  return ref_mesh.make_mesh((p,), ("x",), devices=jax.devices()[:p])


@pytest.mark.parametrize("n, p", [(700, 3), (700, 4), (5, 8), (3, 4)],
                         ids=str)
def test_banded_onehot_spmv_matches_the_reference(n, p, rng):
  S = _ell(n, 700, 0.02, 13)
  x = rng.standard_normal(700).astype(np.float32)
  want = np.asarray(ref_spmv.sharded_onehot_spmv(
      jnp.asarray(S.cols.numpy()), jnp.asarray(S.vals.numpy()),
      jnp.asarray(x), mesh=_ref_mesh(p), interpret=True))
  xt = torch.as_tensor(x)
  before = KS.counts["sharded_ell_plain_runs"]
  got = KS.sharded_onehot_spmv(S.cols, S.vals, xt, sp.make_mesh("cpu",
                                                               shape=(p,)))
  assert KS.counts["sharded_ell_plain_runs"] == before + len(
      KS.ell_bands(n, p))
  assert got.shape == (n,) and got.dtype == torch.float32
  scale = max(np.abs(want).max(), np.finfo(np.float32).tiny)
  assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
  assert torch.equal(got, KS.spmv_ell(S.cols, S.vals, xt))


# -- K3d: K3b's rows over a table of CSR row bands ------------------------------


def _csr(n, m=700, density=0.02, seed=0):
  return ss.random(n, m, density=density, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(seed + n))


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_csr_band_table_holds_each_bands_addresses_and_rows(p):
  A = _csr(5000)
  packed = KS.pack_windowed_sharded(A, p)
  y = torch.empty(5000, dtype=torch.float32)
  bands = KS.csr_bands(packed, y)
  table = KS.csr_band_table(bands)
  full = [d for d in range(p) if packed.rows(d)[1] > packed.rows(d)[0]]
  assert len(table) == len(bands) == len(full)
  for d, (indptr, indices, data, rows), entry in zip(full, bands, table):
    r0, r1 = packed.rows(d)
    band = packed.bands[d]
    assert entry == [indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                     y.data_ptr() + 4 * r0, r1 - r0]
    # views of the pack's band: nothing copied for float32 operands
    assert indptr.data_ptr() == band[0].data_ptr()
    assert indices.data_ptr() == band[1].data_ptr()
    assert data.data_ptr() == band[2].data_ptr()
    assert int(indptr[0]) == 0 and int(indptr[-1]) == indices.shape[0]
    assert rows.shape == (r1 - r0,) and r1 - r0 >= 1


class _CsrLaunches:
  """``build.launch`` for K3b's entry point on CPU tensors: reads the
  table back, finds each band's tensors by their addresses and runs its
  rows through the plain version."""

  def __init__(self, bands, x, group):
    self.by_address = {b[0].data_ptr(): b for b in bands}
    self.x, self.group = x, group
    self.calls = []

  def __call__(self, name, device, table, count, x_ptr, group):
    assert name == "spmv_csr" and 1 <= count <= KS.MAX_BANDS
    assert x_ptr == self.x.data_ptr() and group == self.group
    rows = (ctypes.c_int64 * (5 * count)).from_address(table)
    self.calls.append(count)
    for b in range(count):
      indptr, indices, data, y = self.by_address.pop(rows[5 * b])
      assert rows[5 * b:5 * b + 5] == [
          indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
          y.data_ptr(), y.shape[0]]
      y[:] = KS.spmv_csr_plain(indptr, indices, data, self.x)


@pytest.mark.parametrize("n, p, block", [
    (5000, 2, 1024), (5000, 3, 1024), (5000, 4, 1024), (5000, 8, 1024),
    (3000, 8, 1024), (5, 8, 1), (3, 65, 1), (700, 64, 1), (700, 65, 1),
    (1000, 200, 1)], ids=str)
def test_csr_banded_route_launches_once_for_every_64_bands(n, p, block,
                                                           monkeypatch, rng):
  A = _csr(n)
  cls = KS.ShardedWindowedELL if block == 1024 else KS.ShardedCSR
  packed = cls.pack(A, p)
  x = torch.as_tensor(rng.standard_normal(700).astype(np.float32))
  y = torch.empty(n, dtype=torch.float32)
  bands = KS.csr_bands(packed, y)
  assert len(bands) == sum(packed.rows(d)[1] > packed.rows(d)[0]
                           for d in range(p))
  stub = _CsrLaunches(bands, x, packed.group)
  monkeypatch.setattr(build, "launch", stub)
  assert KS._launch_csr_bands(bands, x, packed.group) == -(
      -len(bands) // KS.MAX_BANDS)
  assert stub.calls == [min(KS.MAX_BANDS, len(bands) - lo)
                        for lo in range(0, len(bands), KS.MAX_BANDS)]
  assert not stub.by_address  # every band launched once
  whole = KS.pack_windowed(A)
  assert torch.equal(y, KS.spmv_csr(whole.indptr, whole.indices, whole.data,
                                    x))


@pytest.mark.parametrize("n", [1, 700, 5000])
def test_spmv_csr_launches_a_table_of_one_band(n, monkeypatch, rng):
  A = _csr(n)
  whole = KS.pack_windowed(A)
  x = torch.as_tensor(rng.standard_normal(700).astype(np.float32))
  seen = []

  def launch(name, device, table, count, x_ptr, group):
    assert name == "spmv_csr" and count == 1
    seen.append(list((ctypes.c_int64 * 5).from_address(table)))
    assert group == KS.group_size(A.nnz / n)

  monkeypatch.setattr(build, "launch", launch)
  y = torch.empty(n, dtype=torch.float32)
  band = (whole.indptr, whole.indices, whole.data, y)
  assert KS._launch_csr_bands([band], x, KS.group_size(A.nnz / n)) == 1
  assert seen == [[whole.indptr.data_ptr(), whole.indices.data_ptr(),
                   whole.data.data_ptr(), y.data_ptr(), n]]
