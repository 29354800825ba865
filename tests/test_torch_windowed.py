"""The windowed SpMV entry point: ``make_spmv_windowed`` over both pack
kinds and K3c's plain version, against the reference's
``make_spmv_windowed(pack_windowed_unique(A), interpret=True)`` and
``pack_windowed(A)`` on tests/test_kernels.py's matrices, from the same
seeded inputs.

Tolerances: the unique pack at 2e-6 of max|y| (the reference's unique
kernel sums exact float32 products, about 2e-7 from scipy, and the port
sums the same products in another order); the classic pack at 1e-5 of
max|y| (the reference's classic kernel reads x and the products through
bf16 hi/lo halves, about 3e-6, ``spmv_pallas.py:25``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

from spartan_tpu.backend.kernels import spmv_pallas as sk

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmv as KS


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _random(rng, n=3000, m=2500, per_row=9):
  """tests/test_kernels.py's unique-pack matrix: duplicates summed."""
  nnz = n * per_row
  r, c = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
  v = rng.standard_normal(nnz).astype(np.float32)
  A = ss.coo_matrix((v, (r, c)), shape=(n, m)).tocsr()
  A.sum_duplicates()
  return A


def _heavy_duplicates(rng):
  B = ss.lil_matrix((1100, 1100), dtype=np.float32)
  B[5, 0:200] = rng.standard_normal(200)
  B[5, 1024:1060] = rng.standard_normal(36)
  return B.tocsr()


def _empty_blocks():
  A = ss.random(4096, 2500, density=0.004, random_state=3, format="lil",
                dtype=np.float32)
  A[2048:3072, :] = 0
  A = A.tocsr()
  A.eliminate_zeros()
  return A


MATRICES = {"random": lambda rng: _random(rng),
            "square random": lambda rng: _random(rng, 3000, 3000),
            "heavy duplicates": _heavy_duplicates,
            "empty row blocks": lambda rng: _empty_blocks()}


def _close(got, want, rel):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("kind, rel", [("unique", 2e-6), ("classic", 1e-5)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_make_spmv_windowed_matches_reference(name, kind, rel):
  rng = np.random.default_rng(42)
  A = MATRICES[name](rng)
  x = rng.standard_normal(A.shape[1]).astype(np.float32)
  ref_pack = sk.pack_windowed_unique if kind == "unique" else sk.pack_windowed
  port_pack = (KS.pack_windowed_unique if kind == "unique"
               else KS.pack_windowed)
  want = sk.make_spmv_windowed(ref_pack(A), interpret=True)(jnp.asarray(x))
  packed = port_pack(A)
  assert (packed.chunk_row is not None) == (kind == "unique")
  before = dict(KS.counts)
  got = KS.make_spmv_windowed(packed)(torch.from_numpy(x))
  key = "chunked_plain_runs" if kind == "unique" else "csr_plain_runs"
  assert KS.counts == dict(before, **{key: before[key] + 1})
  assert got.dtype == torch.float32
  _close(got.numpy(), want, rel)
  if name == "empty row blocks":
    assert not got[2048:3072].any()


@pytest.mark.parametrize("pack", [KS.pack_windowed, KS.pack_windowed_unique],
                         ids=["classic", "unique"])
def test_float64_x_raises_and_bfloat16_x_keeps_its_dtype(pack):
  A = _random(np.random.default_rng(1), 300, 200)
  fn = pack(A)
  spmv = KS.make_spmv_windowed(fn, use_bf16=True)
  x = torch.from_numpy(np.random.default_rng(2).standard_normal(200))
  with pytest.raises(NotImplementedError, match="f32/bf16 only"):
    spmv(x)
  y = spmv(x.to(torch.bfloat16))
  assert y.dtype == torch.bfloat16 and y.shape == (300,)
  with pytest.raises(ValueError, match="shape"):
    spmv(x[:199].float())


def test_pack_of_a_sparse_array_matches_the_pack_of_scipy():
  A = _random(np.random.default_rng(5), 500, 400)
  from_scipy = KS.pack_windowed_unique(A)
  from_port = KS.pack_windowed_unique(sps.from_scipy(A))
  for name in ("indptr", "indices", "data", "chunk_row"):
    assert torch.equal(getattr(from_scipy, name), getattr(from_port, name))
  assert from_scipy.shape == from_port.shape == (500, 400)
  assert from_scipy.nnz == from_port.nnz == A.nnz


LENGTH_PATTERNS = {
    "no nonzero": [0, 0, 0],
    "below one chunk": [3, 0, 7, 1],
    "rows on chunk boundaries": [512, 512, 1024, 256, 768, 1024, 3],
    "empty rows at both ends": [0, 0, 700, 900, 0, 0],
    "a row of 12 chunks": [5, 12 * KS.CHUNK + 17, 0, 9],
    "empty rows on a boundary": [KS.CHUNK, 0, 0, 0, KS.CHUNK, 0],
}


@pytest.mark.parametrize("name", sorted(LENGTH_PATTERNS))
def test_chunk_rows_finds_the_row_of_each_chunks_first_nonzero(name):
  lengths = np.asarray(LENGTH_PATTERNS[name], np.int64)
  indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]))
  rows = KS.chunk_rows(indptr)
  nnz = int(indptr[-1])
  assert rows.dtype == torch.int64 and rows.shape == (-(-nnz // KS.CHUNK),)
  for c, r in enumerate(rows.tolist()):
    assert indptr[r] <= c * KS.CHUNK < indptr[r + 1]


def test_spmv_chunked_plain_and_wrapper_checks():
  A = _random(np.random.default_rng(7), 400, 300)
  p = KS.pack_windowed_unique(A)
  x = torch.from_numpy(np.random.default_rng(8).standard_normal(300)
                       .astype(np.float32))
  got = KS.spmv_chunked(p.indptr, p.indices, p.data, p.chunk_row, x)
  assert torch.equal(got, KS.spmv_csr_plain(p.indptr, p.indices, p.data, x))
  with pytest.raises(ValueError, match="chunk_row"):
    KS.spmv_chunked(p.indptr, p.indices, p.data, p.chunk_row[:-1], x)
  with pytest.raises(TypeError, match="int32"):
    KS.spmv_chunked(p.indptr, p.indices.long(), p.data, p.chunk_row, x)
  with pytest.raises(TypeError, match="float32/bfloat16/float16"):
    KS.spmv_chunked(p.indptr, p.indices, p.data, p.chunk_row, x.double())
  with pytest.raises(TypeError, match="scipy sparse matrix or a SparseArray"):
    KS.pack_windowed(A.toarray())
