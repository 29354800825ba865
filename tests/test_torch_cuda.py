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


# -- 3x3 stencil kernels K4 (stencil3x3) and K6a (stencil3x3_padded) -----------
# float32: equal to the plain version bit for bit (the same IEEE-rounded ops
# in the same order).  bfloat16/float16: per step 2·(taps + 1)·u of the
# largest Σ|c·x| + |add| the steps reach, grown by the gain Σ|c| of each
# later step (u = 2^-8, 2^-11).

from spartan_tpu_torch.backend.kernels import stencil as K6  # noqa: E402

STENCIL_SHAPES = [(1, 1), (3, 5), (13, 20), (64, 256), (1000, 1001),
                  (4097, 130)]
STENCIL_COEFFS = {"laplacian": (0.0, 1.0, 0.0, 1.0, -4.0, 1.0, 0.0, 1.0, 0.0),
                  "nine": (0.05, 0.1, 0.02, 0.1, 0.4, -0.1, 0.3, 0.1, 0.03)}
LOW_UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _stencil_tol(dtype, coeffs, steps, x_max, add_max=0.0):
  if dtype == torch.float32:
    return 0.0
  gain = sum(abs(c) for c in coeffs)
  taps = sum(c != 0.0 for c in coeffs)
  scale, worst = x_max, 0.0
  for _ in range(steps):
    scale = gain * scale + add_max
    worst = max(worst, scale)
  return (2 * (taps + 1) * LOW_UNIT[dtype] * steps * worst
          * max(gain, 1.0) ** (steps - 1))


def _assert_stencil_close(got, want, tol):
  assert got.dtype == want.dtype and got.shape == want.shape
  if tol == 0.0:
    assert torch.equal(got, want)
  else:
    assert float((got.double() - want.double()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("coeffs", sorted(STENCIL_COEFFS))
@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=str)
def test_stencil3x3_kernel_matches_plain(device, shape, coeffs, dtype):
  cs = STENCIL_COEFFS[coeffs]
  gen = torch.Generator(device=device).manual_seed(shape[0] + shape[1])
  x = torch.randn(shape, generator=gen, device=device).to(dtype)
  before = dict(K6.counts)
  got = K6.stencil3x3(x, cs)
  torch.cuda.synchronize()
  assert K6.counts == dict(before, k4_launches=before["k4_launches"] + 1)
  _assert_stencil_close(got, K6.stencil3x3_plain(x, cs),
                        _stencil_tol(dtype, cs, 1, float(x.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("with_add", [False, True], ids=["no_add", "add"])
@pytest.mark.parametrize("coeffs", sorted(STENCIL_COEFFS))
@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=str)
def test_stencil3x3_padded_kernel_matches_plain(device, shape, coeffs,
                                                with_add, dtype):
  cs = STENCIL_COEFFS[coeffs]
  gen = torch.Generator(device=device).manual_seed(shape[0] * shape[1])
  x = torch.randn(shape, generator=gen, device=device).to(dtype)
  g = torch.randn(shape, generator=gen, device=device).to(dtype)
  xp = K6.to_padded(x)
  add = K6.to_padded(g) if with_add else None
  for steps in (1, 2, 3):
    before = K6.counts["k6a_launches"]
    got, other = K6.stencil3x3_padded(xp.clone(), torch.zeros_like(xp), cs,
                                      steps, add)
    torch.cuda.synchronize()
    assert K6.counts["k6a_launches"] == before + steps
    want, want_other = K6.stencil3x3_padded_plain(
        xp.clone(), torch.zeros_like(xp), cs, steps, add)
    tol = _stencil_tol(dtype, cs, steps, float(x.abs().max()),
                       float(g.abs().max()) if with_add else 0.0)
    _assert_stencil_close(got, want, tol)
    if steps > 1:
      _assert_stencil_close(other, want_other, tol)


def test_stencil3x3_padded_kernel_leaves_the_ring_of_buf(device):
  x = torch.randn(100, 300, device=device)
  xp = K6.to_padded(x)
  buf = torch.full_like(xp, float("nan"))
  new, old = K6.stencil3x3_padded(xp, buf, STENCIL_COEFFS["nine"])
  assert new is buf and old is xp
  inner = K6.from_padded(new)
  torch.testing.assert_close(inner, K6.stencil3x3(x, STENCIL_COEFFS["nine"]),
                             rtol=0, atol=0)
  inner.zero_()
  assert bool(new.isnan().sum() == new.numel() - x.numel())


def test_stencil_kernels_are_deterministic_and_route_float64_plain(device):
  x = torch.randn(513, 1025, device=device)
  cs = STENCIL_COEFFS["laplacian"]
  assert torch.equal(K6.stencil3x3(x, cs), K6.stencil3x3(x, cs))
  before = dict(K6.counts)
  got = K6.stencil3x3(x.double(), cs)
  xp = K6.to_padded(x.double())
  new, _ = K6.stencil3x3_padded(xp, torch.zeros_like(xp), cs, 2)
  assert K6.counts == dict(before, routed_plain=before["routed_plain"] + 2)
  assert got.dtype == new.dtype == torch.float64
  torch.testing.assert_close(got, K6.stencil3x3_plain(x.double(), cs),
                             rtol=0, atol=0)


def test_stencil_wrappers_refuse_operand_mixes(device):
  xp = K6.to_padded(torch.randn(20, 30, device=device))
  with pytest.raises(ValueError, match="one device"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp).cpu(),
                         STENCIL_COEFFS["nine"])
  with pytest.raises(ValueError, match="one device"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp), STENCIL_COEFFS["nine"],
                         add=xp.cpu())
  with pytest.raises(ValueError, match="contiguous"):
    wide = torch.zeros(xp.shape[0], 2 * xp.shape[1], device=device)
    K6.stencil3x3_padded(xp, wide[:, ::2], STENCIL_COEFFS["nine"])
  with pytest.raises(ValueError, match="distinct"):
    K6.stencil3x3_padded(xp, xp, STENCIL_COEFFS["nine"])


def test_heat_and_jacobi_launch_the_padded_kernel_on_card(device):
  from spartan_tpu_torch.examples import heat, poisson
  rng = np.random.default_rng(9)
  u0 = rng.random((200, 300)).astype(np.float32)
  before = K6.counts["k6a_launches"]
  got = heat.simulate_padded(u0, iters=30, alpha=0.2, unroll=7)
  f = rng.standard_normal((200, 300)).astype(np.float32)
  u = poisson.solve_jacobi(f, iters=20)
  assert K6.counts["k6a_launches"] == before + 50
  # float32 sweeps against float64: (taps + 1)·2^-24·max|u| a sweep, gain 1
  assert np.abs(got - heat.simulate_numpy(u0, 30, 0.2)).max() <= (
      30 * 12 * 2.0 ** -24)
  want = poisson.solve_jacobi_numpy(f, iters=20)
  assert np.abs(u - want).max() <= 20 * 10 * 2.0 ** -24 * (
      np.abs(want).max() + 0.25 * np.abs(f).max())
