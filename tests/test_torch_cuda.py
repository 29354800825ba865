"""Card-only tests of the port: kernels K1 (csrc/fused_reduce.cu), K3a
(csrc/spmv_ell.cu), K3b (csrc/spmv_csr.cu) and K5a (csrc/spmm_csr.cu)
against their plain torch versions on the same CUDA tensors, and the
expression layer's, PageRank's and ALS's kernel paths.  Run on a machine with an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: rtol 1e-9 with a float64 accumulator for chains of
IEEE-rounded ops (only the summation order differs), 1e-6 for chains with
exp/log (the CUDA and torch implementations differ by an ulp), 1e-5 with a
float32 accumulator.
"""

import numpy as np
import pytest
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput
from spartan_tpu_torch.expr.map import UFUNCS

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
  sp.initialize(["--device=cuda"])
  return sp.get_mesh().device


def call(name, *deps):
  return FnCallExpr(UFUNCS[name], list(deps))


V, S = LocalInput(0), LocalInput(1)
CHAINS = {
    "identity": (None, False, False),
    "one_plus_2v": (call("add", LocalConst(1.0),
                         call("multiply", V, LocalConst(2.0))), False, False),
    "abs_one_plus_2v": (call("absolute", call(
        "add", LocalConst(1.0), call("multiply", V, LocalConst(2.0)))),
                        False, False),
    "exp_neg_v2": (call("exp", call("multiply", call("negative", V), V)),
                   True, False),
    "runtime_scalar": (call("maximum", call("multiply", V, S),
                            call("sqrt", S)), False, True),
}


def _rtol(transcendental, acc):
  if acc == torch.float32:
    return 1e-5
  return 1e-6 if transcendental else 1e-9


@pytest.mark.parametrize("acc", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("shape", [(1024, 1024), (10_000_019,), (13, 20)],
                         ids=str)
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_kernel_matches_plain(device, chain, shape, dtype, acc):
  local_op, transcendental, has_scalar = CHAINS[chain]
  gen = torch.Generator(device=device).manual_seed(5)
  x = (torch.rand(shape, generator=gen, device=device) * 3 - 1).to(dtype)
  scalars = ([torch.tensor(0.7, dtype=torch.float64, device=device)]
             if has_scalar else [])
  program = K.plan(local_op, 0, dtype, dict(enumerate(scalars, start=1)))
  before = K.counts["launches"]
  got = K.fused_sum(x, program, scalars, acc)
  torch.cuda.synchronize()
  assert K.counts["launches"] == before + 1
  want = K.fused_sum_plain(x, program, scalars, acc)
  assert got.dtype == want.dtype == acc
  np.testing.assert_allclose(got.item(), want.item(),
                             rtol=_rtol(transcendental, acc))


def test_kernel_is_deterministic(device):
  x = torch.randn(4_000_037, device=device)
  program = K.plan(CHAINS["abs_one_plus_2v"][0], 0, torch.float32, {})
  a = K.fused_sum(x, program, [], torch.float64)
  b = K.fused_sum(x, program, [], torch.float64)
  assert a.item() == b.item()


def test_launch_refuses_what_the_kernel_does_not_take(device):
  program = K.plan(None, 0, torch.float32, {})
  x = torch.ones(64, 64, device=device)
  with pytest.raises(ValueError, match="contiguous"):
    K.fused_sum(x.t(), program, [], torch.float64)
  with pytest.raises(TypeError, match="float32/bfloat16/float16"):
    K.fused_sum(x.double(), program, [], torch.float64)


def test_expression_layer_launches_kernel_on_card(device):
  host = np.random.default_rng(2).standard_normal((512, 768)).astype(
      np.float32)
  b = sp.from_numpy(host)
  before = dict(K.counts)
  affine = float((sp.ones((512, 768)) + b * 2).sum().glom())
  assert K.counts == before
  got = float(abs(1 + b * 2).sum().glom())
  assert K.counts["launches"] == before["launches"] + 1
  want64 = host.astype(np.float64)
  np.testing.assert_allclose(affine, (1 + want64 * 2).sum(), rtol=1e-9)
  np.testing.assert_allclose(
      got, np.abs(1 + host * np.float32(2)).astype(np.float64).sum(),
      rtol=1e-9)


def test_untranslatable_chain_routes_plain_on_card(device):
  b = sp.from_numpy(np.linspace(0, 1, 4096, dtype=np.float32))
  before = dict(K.counts)
  got = float(sp.map(b, torch.sin).sum().glom())
  assert K.counts["routed_plain"] == before["routed_plain"] + 1
  assert K.counts["launches"] == before["launches"]
  np.testing.assert_allclose(
      got, np.sin(np.linspace(0, 1, 4096, dtype=np.float32)).astype(
          np.float64).sum(), rtol=1e-6)


# -- SpMV kernels K3a (spmv_ell) and K3b (spmv_csr) ----------------------------
# Tolerance: max |kernel - plain| <= 1e-5 max|y|, float32 sums of the same
# products in another order.

from spartan_tpu_torch.backend import sparse as sps  # noqa: E402
from spartan_tpu_torch.backend.kernels import spmv as KS  # noqa: E402


def _matrix(kind):
  import scipy.sparse as ss
  if kind == "random":
    return ss.random(1500, 2300, density=0.005, random_state=3, format="csr",
                     dtype=np.float32)
  if kind == "empty_rows":
    A = ss.random(4096, 2500, density=0.004, random_state=4, format="lil",
                  dtype=np.float32)
    A[2048:3072, :] = 0
    return A.tocsr()
  if kind == "long_row":
    A = ss.random(64, 20000, density=0.0003, random_state=5, format="lil",
                  dtype=np.float32)
    A[7, np.random.default_rng(5).choice(20000, 10_000, replace=False)] = 1.5
    return A.tocsr()
  return ss.random(13, 20, density=0.3, random_state=6, format="csr",
                   dtype=np.float32)


MATRICES = ["random", "empty_rows", "long_row", "tiny"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("kind", MATRICES)
def test_spmv_kernels_match_plain(device, kind, dtype):
  S = sps.from_scipy(_matrix(kind))
  gen = torch.Generator(device=device).manual_seed(8)
  x = torch.randn(S.shape[1], generator=gen, device=device).to(dtype)
  vals = S.vals.to(dtype)
  indptr, indices, data = S.to_csr()
  for kernel, plain, args, key in (
      (KS.spmv_ell, KS.spmv_ell_plain, (S.cols, vals, x), "ell_launches"),
      (KS.spmv_csr, KS.spmv_csr_plain, (indptr, indices, data, x),
       "csr_launches")):
    before = dict(KS.counts)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert KS.counts[key] == before[key] + 1
    assert KS.counts["ell_plain_runs"] == before["ell_plain_runs"]
    assert KS.counts["csr_plain_runs"] == before["csr_plain_runs"]
    want = plain(*args)
    assert got.dtype == want.dtype and got.device == x.device
    scale = float(want.float().abs().max())
    # the result is rounded to dtype on both sides: one ulp of dtype
    ulp = {torch.float32: 0.0, torch.bfloat16: 2 ** -8,
           torch.float16: 2 ** -11}[dtype]
    tol = (1e-5 + ulp) * scale if kind != "long_row" else (
        (S.max_nnz_per_row * 2.0 ** -24 + ulp) * float(
            KS.spmv_csr_plain(indptr, indices, data.abs(),
                              x.float().abs()).max()))
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_spmv_kernels_are_deterministic(device):
  S = sps.from_scipy(_matrix("random"))
  x = torch.randn(S.shape[1], device=device)
  assert torch.equal(KS.spmv_ell(S.cols, S.vals, x),
                     KS.spmv_ell(S.cols, S.vals, x))
  assert torch.equal(KS.spmv_csr(*S.to_csr(), x), KS.spmv_csr(*S.to_csr(), x))


def test_spmv_wrappers_refuse_what_the_kernels_do_not_take(device):
  S = sps.from_scipy(_matrix("tiny"))
  x = torch.randn(S.shape[1], device=device)
  with pytest.raises(TypeError, match="int32 cols"):
    KS.spmv_ell(S.cols.long(), S.vals, x)
  with pytest.raises(TypeError, match="float32/bfloat16/float16"):
    KS.spmv_ell(S.cols, S.vals, x.double())
  with pytest.raises(ValueError, match="one device"):
    KS.spmv_csr(*S.to_csr(), x.cpu())


@pytest.mark.parametrize("n, fmt, key", [(2048, "ell", "ell_launches"),
                                         (40000, "win", "csr_launches")])
def test_spmv_expr_launches_its_kernel_on_card(device, n, fmt, key):
  import scipy.sparse as ss
  A = ss.random(n, n, density=8.0 / n, random_state=1, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
  e = sps.spmv_expr(S, sp.from_numpy(x))
  assert e.fmt == fmt
  before = dict(KS.counts)
  got = e.glom()
  assert KS.counts[key] == before[key] + 1
  assert KS.counts["ell_plain_runs"] == before["ell_plain_runs"]
  assert KS.counts["csr_plain_runs"] == before["csr_plain_runs"]
  want = A.astype(np.float64) @ x.astype(np.float64)
  assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
  eager = sps.spmv(S, x)
  assert KS.counts[key] == before[key] + 2
  np.testing.assert_allclose(eager.cpu().numpy(), got, rtol=0, atol=1e-5 *
                             np.abs(want).max())


def test_pagerank_fit_sparse_on_card(device):
  from spartan_tpu_torch.examples import pagerank
  import scipy.sparse as ss
  M = pagerank.make_link_matrix(512)
  got = pagerank.fit_sparse(sps.from_scipy(ss.csr_matrix(M.astype(np.float32))),
                            iterations=20)
  r = np.full(512, 1.0 / 512)
  for _ in range(20):
    r = 0.85 * (M @ r) + 0.15 / 512
  assert np.abs(got - r).max() <= 1e-5 * r.max()


# -- SpMM kernel K5a (spmm_csr) -------------------------------------------------
# Tolerance: per entry, 2·len(row)·2^-24·Σ_p |data_p · B[indices_p, c]|: both
# sides sum the same rounded float32 products in another order.

from spartan_tpu_torch.backend.kernels import spmm as K5  # noqa: E402


def _spmm_tolerance(indptr, indices, data, B):
  lengths = (indptr[1:] - indptr[:-1]).double()
  sum_abs = K5.spmm_csr_plain(indptr, indices, data.abs(), B.float().abs())
  return 2.0 * lengths[:, None] * 2.0 ** -24 * sum_abs.double()


@pytest.mark.parametrize("bdtype", [torch.float32, torch.bfloat16,
                                    torch.float16, torch.float64], ids=str)
@pytest.mark.parametrize("k", [1, 3, 64, 130, 512])
@pytest.mark.parametrize("kind", MATRICES)
def test_spmm_kernel_matches_plain(device, kind, k, bdtype):
  S = sps.from_scipy(_matrix(kind))
  indptr, indices, data = S.to_csr()
  gen = torch.Generator(device=device).manual_seed(k)
  B = torch.randn(S.shape[1], k, generator=gen, device=device).to(bdtype)
  before = dict(K5.counts)
  got = K5.spmm_csr(indptr, indices, data, B)
  torch.cuda.synchronize()
  assert K5.counts["launches"] == before["launches"] + 1
  assert K5.counts["plain_runs"] == before["plain_runs"]
  want = K5.spmm_csr_plain(indptr, indices, data, B)
  assert got.dtype == want.dtype == torch.promote_types(torch.float32, bdtype)
  assert got.shape == (S.shape[0], k) and got.device == B.device
  diff = (got.double() - want.double()).abs()
  assert bool((diff <= _spmm_tolerance(indptr, indices, data, B)).all())
  assert torch.equal(got, K5.spmm_csr(indptr, indices, data, B))


def test_spmm_kernel_reads_a_transposed_view(device):
  S = sps.from_scipy(_matrix("random"))
  indptr, indices, data = S.to_csr()
  Bt = torch.randn(64, S.shape[1], device=device)
  got = K5.spmm_csr(indptr, indices, data, Bt.t())
  want = K5.spmm_csr_plain(indptr, indices, data, Bt.t().contiguous())
  diff = (got.double() - want.double()).abs()
  assert bool((diff <= _spmm_tolerance(indptr, indices, data,
                                       Bt.t().contiguous())).all())


def test_spmm_wrapper_refuses_what_the_kernel_does_not_take(device):
  S = sps.from_scipy(_matrix("tiny"))
  indptr, indices, data = S.to_csr()
  B = torch.randn(S.shape[1], 4, device=device)
  with pytest.raises(ValueError, match="k <= 512"):
    K5.spmm_csr(indptr, indices, data, torch.randn(S.shape[1], 513,
                                                   device=device))
  with pytest.raises(TypeError, match="float B"):
    K5.spmm_csr(indptr, indices, data, B.long())
  with pytest.raises(ValueError, match="one device"):
    K5.spmm_csr(indptr, indices, data, B.cpu())


def test_spmm_expr_and_spmm_launch_the_kernel_on_card(device):
  import scipy.sparse as ss
  A = ss.random(3000, 2000, density=0.01, random_state=2, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  B = np.random.default_rng(4).standard_normal((2000, 48))
  e = sps.spmm_expr(S, sp.from_numpy(B))
  assert e.fmt == "winmm"
  before = dict(K5.counts)
  got = e.glom()
  eager = sps.spmm(S, B)
  assert K5.counts["launches"] == before["launches"] + 2
  assert K5.counts["plain_runs"] == before["plain_runs"]
  want = A.astype(np.float64) @ B
  assert got.dtype == np.float64
  assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
  np.testing.assert_array_equal(eager.cpu().numpy(), got)


def test_als_fit_on_card_matches_float64(device):
  import scipy.sparse as ss
  from spartan_tpu_torch.examples import als
  R = ss.random(600, 400, density=0.05, random_state=5, format="csr")
  R.data = np.round(R.data * 9 + 1) / 2
  before = K5.counts["launches"]
  U, V = als.fit(sps.from_scipy(R, dtype=np.float32), k=8, iterations=3)
  assert K5.counts["launches"] == before + 6
  rng = np.random.default_rng(0)
  U64, V64 = rng.standard_normal((600, 8)) * 0.1, rng.standard_normal(
      (400, 8)) * 0.1
  R32 = R.astype(np.float32).astype(np.float64)
  for _ in range(3):
    U64 = np.linalg.solve(V64.T @ V64 + 0.1 * np.eye(8), (R32 @ V64).T).T
    V64 = np.linalg.solve(U64.T @ U64 + 0.1 * np.eye(8), (R32.T @ U64).T).T
  assert np.abs(U - U64).max() <= 1e-4 * np.abs(U64).max()
  assert np.abs(V - V64).max() <= 1e-4 * np.abs(V64).max()
