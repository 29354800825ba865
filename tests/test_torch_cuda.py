"""Card-only tests of the port: kernels K1 (csrc/fused_reduce.cu), K2
(csrc/matmul.cu), K3a (csrc/spmv_ell.cu), K3b (csrc/spmv_csr.cu), K3c
(csrc/spmv_chunked.cu), K5a (csrc/spmm_csr.cu), K4, K6a and K6b
(csrc/stencil3x3*.cu) against their plain torch versions on the same CUDA
tensors; the sharded entry points (K3a sharded, K3d, K5b, K6b) against
their unsharded kernels; the expression layer's, PageRank's, ALS's, the
stencil examples' and make_spmv_windowed's kernel paths; shuffle, integer
dot, k-means and logistic regression on the card.  Run on a machine with
an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances (K1's here; each later section states its own): rtol 1e-9
with a float64 accumulator for chains of IEEE-rounded ops, floor division
and remainder among them (only the summation order differs), 1e-6 for
chains with exp/log/pow (the CUDA and torch implementations differ by an
ulp), 1e-5 with a float32 accumulator.
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
    # floor division and remainder: torch's algorithm, IEEE-rounded steps
    "v_floordiv": (call("floor_divide", V, LocalConst(0.3)), False, False),
    "v_mod": (call("remainder", V, LocalConst(0.7)), False, False),
    "square_via_power": (call("power", V, LocalConst(2.0)), False, False),
    # powf/pow carry the CUDA math library's ulp bounds
    "v_pow_3": (call("power", V, LocalConst(3.0)), True, False),
    "abs_v_pow_2_5": (call("power", call("absolute", V), LocalConst(2.5)),
                      True, False),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097])
def test_kernel_takes_ragged_tails_and_misaligned_views(device, n, dtype):
  """Lengths that end inside a 16-byte load, and x[1:] of a flattened
  tensor (a base 2 or 4 bytes past an aligned one): the elements outside
  the aligned body go through the same program one at a time."""
  gen = torch.Generator(device=device).manual_seed(n)
  base = (torch.rand(n + 1, generator=gen, device=device) * 3 - 1).to(dtype)
  for name in ("abs_one_plus_2v", "runtime_scalar"):
    local_op, transcendental, has_scalar = CHAINS[name]
    scalars = ([torch.tensor(0.7, dtype=torch.float64, device=device)]
               if has_scalar else [])
    program = K.plan(local_op, 0, dtype, dict(enumerate(scalars, start=1)))
    for x in (base[:n], base.reshape(-1)[1:]):
      for acc in (torch.float32, torch.float64):
        before = K.counts["launches"]
        got = K.fused_sum(x, program, scalars, acc)
        again = K.fused_sum(x, program, scalars, acc)
        torch.cuda.synchronize()
        assert K.counts["launches"] == before + 2
        want = K.fused_sum_plain(x, program, scalars, acc)
        np.testing.assert_allclose(got.item(), want.item(),
                                   rtol=_rtol(transcendental, acc))
        assert got.item() == again.item()


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


def test_new_operators_launch_k1_through_the_expression_layer(device):
  """``(b ** 2).sum()``, ``(b // 0.3).sum()`` and ``(b % 0.7).sum()`` each
  launch K1 once, with no plain route; float64 NumPy oracles of the
  float32 chains (rtol 1e-9; the chains are IEEE-rounded)."""
  host = np.random.default_rng(4).uniform(-1.0, 2.0, (513, 770)).astype(
      np.float32)
  b = sp.from_numpy(host)
  with np.errstate(divide="ignore"):
    cases = (((b ** 2).sum(), host * host),
             ((b // 0.3).sum(), host // np.float32(0.3)),
             ((b % 0.7).sum(), host % np.float32(0.7)))
  for expr, elems in cases:
    before = dict(K.counts)
    got = float(expr.glom())
    assert K.counts["launches"] == before["launches"] + 1
    assert K.counts["routed_plain"] == before["routed_plain"]
    np.testing.assert_allclose(got, elems.astype(np.float64).sum(),
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


# K3a's forms: x in each block's shared memory (16-byte loads where
# k % 4 == 0 and the rows are aligned, else 4-byte ones) and, past the
# on-chip capacity, through L1.  A long row is held to a float64 product:
# float32 sums of k products, |err| <= (k + 1) 2^-24 sum|a x|.

def _urand_ell(n, degree=16, seed=0):
  import scipy.sparse as ss
  rng = np.random.default_rng(seed)
  return sps.from_scipy(ss.csc_matrix(
      (np.full(degree * n, 1 / degree, np.float32),
       rng.integers(0, n, degree * n).astype(np.int32),
       np.arange(0, degree * n + 1, degree)), shape=(n, n)))


def _held_to_float64(S, x, got):
  cols, vals = S.cols.long(), S.vals.double()
  want = (vals * x.double()[cols]).sum(1)
  bound = (S.cols.shape[1] + 1) * 2.0 ** -24 * (
      vals.abs() * x.double().abs()[cols]).sum(1)
  return bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("kind", MATRICES + ["urand"])
def test_k3a_on_chip_matches_plain_and_repeats_bit_for_bit(device, kind):
  S = _urand_ell(32768) if kind == "urand" else sps.from_scipy(_matrix(kind))
  gen = torch.Generator(device=device).manual_seed(12)
  x = torch.randn(S.shape[1], generator=gen, device=device)
  assert KS.ell_on_chip(S.shape[1])
  narrow = KS.ell_form(S.cols, S.vals, S.shape[1])[1] == 1  # 4-byte loads
  before = dict(KS.counts)
  first = KS.spmv_ell(S.cols, S.vals, x)
  torch.cuda.synchronize()
  assert KS.counts == dict(
      before, ell_launches=before["ell_launches"] + 1,
      ell_4byte_launches=before["ell_4byte_launches"] + narrow)
  want = KS.spmv_ell_plain(S.cols, S.vals, x)
  assert _held_to_float64(S, x, first)
  if kind != "long_row":
    assert float((first - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
  assert torch.equal(KS.spmv_ell(S.cols, S.vals, x), first)
  assert KS.counts["ell_through_l1_launches"] == 0


def _k3a_order(cols, vals, x, group):
  """K3a's float32 result in its on-chip sum order (tests/
  test_torch_spmv_clusters.py's emulation): lane l's pieces of 4 entries
  l, l + G, ... in entry order, then the tree."""
  n, k = cols.shape
  prods = vals * x[cols]
  lanes = np.zeros((n, group), np.float32)
  for lane in range(group):
    for j in range(lane, -(-k // 4), group):
      for e in range(4 * j, min(4 * j + 4, k)):
        lanes[:, lane] = lanes[:, lane] + prods[:, e]
  o = group // 2
  while o:
    lanes[:, :o] = lanes[:, :o] + lanes[:, o:2 * o]
    o //= 2
  return lanes[:, 0]


def _urand_ell_k(k):
  """urand 32768's ELL cut or padded to k entries a row (k = 35, 37: rows
  not on 16 bytes, 4-byte loads)."""
  S = _urand_ell(32768)
  cols = torch.zeros((S.shape[0], k), dtype=torch.int32, device=S.cols.device)
  vals = torch.zeros((S.shape[0], k), device=S.vals.device)
  w = min(k, S.cols.shape[1])
  cols[:, :w], vals[:, :w] = S.cols[:, :w], S.vals[:, :w]
  return cols, vals, S.shape[1]


@pytest.mark.parametrize("kind", ["urand", "random", "long_row", "urand35",
                                  "urand37"])
def test_k3a_gives_the_bits_of_its_sum_order(device, kind):
  if kind.startswith("urand") and kind != "urand":
    cols, vals, m = _urand_ell_k(int(kind[5:]))
  else:
    S = _urand_ell(32768) if kind == "urand" else sps.from_scipy(
        _matrix(kind))
    cols, vals, m = S.cols, S.vals, S.shape[1]
  x = torch.randn(m, device=device)
  on_chip, vec, group = KS.ell_form(cols, vals, m)
  assert on_chip
  got = KS.spmv_ell(cols, vals, x)
  want = _k3a_order(cols.cpu().numpy(), vals.cpu().numpy(), x.cpu().numpy(),
                    group)
  np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_k3a_takes_x_through_l1_past_the_on_chip_capacity(device):
  import scipy.sparse as ss
  m = KS.ELL_MAX_X + 3
  S = sps.from_scipy(ss.random(3000, m, density=0.004, random_state=2,
                               format="csr", dtype=np.float32))
  x = torch.randn(m, device=device)
  assert not KS.ell_on_chip(m) and KS.ell_on_chip(m - 3)
  before = dict(KS.counts)
  got = KS.spmv_ell(S.cols, S.vals, x)
  torch.cuda.synchronize()
  assert KS.counts["ell_through_l1_launches"] == (
      before["ell_through_l1_launches"] + 1)
  assert _held_to_float64(S, x, got)


def test_k3a_reads_misaligned_operands(device):
  """x off a 16-byte boundary (copied for the bulk copy) and vals off one
  (4-byte loads, counted): the same bits as the aligned operands', within
  the float32 bound of a float64 product."""
  import scipy.sparse as ss
  n, k = 5000, 12
  rng = np.random.default_rng(3)
  cols = (np.arange(n)[:, None] * k + np.arange(k) * 997) % n  # distinct
  S = sps.from_scipy(ss.csr_matrix(
      (rng.standard_normal(n * k).astype(np.float32), cols.ravel(),
       np.arange(0, n * k + 1, k)), shape=(n, n)))
  assert S.cols.shape == (n, k)
  gen = torch.Generator(device=device).manual_seed(4)
  xs = torch.randn(S.shape[1] + 1, generator=gen, device=device)
  x = xs[1:]
  assert x.data_ptr() % 16 and KS.ell_form(S.cols, S.vals, x.shape[0])[1] == 4
  spare = torch.empty(n * k + 1, device=device)
  vals = spare[1:].view(n, k)
  vals.copy_(S.vals)
  assert KS.ell_form(S.cols, vals, x.shape[0])[1] == 1
  aligned = KS.spmv_ell(S.cols, S.vals, x.clone())
  assert torch.equal(KS.spmv_ell(S.cols, S.vals, x), aligned)
  before = KS.counts["ell_4byte_launches"]
  got = KS.spmv_ell(S.cols, vals, x)
  torch.cuda.synchronize()
  assert KS.counts["ell_4byte_launches"] == before + 1
  assert torch.equal(got, aligned)
  assert _held_to_float64(S, x, got)


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
# Tolerance: both sides sum the same rounded float32 products in another
# order, so per entry they differ by at most 2·len(row)·2^-24·Σ_p |data_p ·
# B[indices_p, c]|.  On these random-signed products the rounding errors add
# like a random walk, and STAT_C·sqrt(len)·2^-24·sqrt(Σ_p (data_p ·
# B[indices_p, c])²) holds too (chip_smoke.py's sum_bound, whose constant is
# about three times the largest share it reads on K2 at 32768^2); the
# tolerance is the smaller of the two.

from spartan_tpu_torch.backend.kernels import spmm as K5  # noqa: E402

STAT_C = 16.0


def _sum_bound(terms, abs_sum, sq_sum, worst):
  """The smaller of the worst case worst·n·2^-24·Σ|t| and the random-walk
  bound STAT_C·sqrt(n)·2^-24·sqrt(Σt²) for two float32 sums of n terms."""
  return torch.minimum(worst * terms * 2.0 ** -24 * abs_sum,
                       STAT_C * terms ** 0.5 * 2.0 ** -24 * sq_sum.sqrt())


def _spmm_tolerance(indptr, indices, data, B):
  lengths = (indptr[1:] - indptr[:-1]).double()[:, None]
  Bf = B.float()
  sum_abs = K5.spmm_csr_plain(indptr, indices, data.abs(), Bf.abs())
  sum_sq = K5.spmm_csr_plain(indptr, indices, data.square(), Bf.square())
  return _sum_bound(lengths, sum_abs.double(), sum_sq.double(), 2.0)


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


# K5a cuts rows into segments of SEG nonzeros: rows of 0, 1, SEG-1, SEG,
# SEG+1, 2·SEG and 7·SEG+3 nonzeros and one of 70,000 among short rows, set
# in different row bands of a mesh of 2, 4 or 8 shards (bands of 128·j rows).
SKEW_ROWS = {5: 0, 140: 1, 300: K5.SEG - 1, 520: K5.SEG, 700: K5.SEG + 1,
             1030: 2 * K5.SEG, 1290: 7 * K5.SEG + 3, 1500: 70_000}


def _skewed_csr(device):
  import scipy.sparse as ss
  rng = np.random.default_rng(47)
  n, m = 2000, 90_000
  lengths = rng.integers(0, 41, n)
  for row, length in SKEW_ROWS.items():
    lengths[row] = length
  cols = np.concatenate([np.sort(rng.choice(m, length, replace=False))
                         for length in lengths]).astype(np.int32)
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  data = rng.standard_normal(indptr[-1]).astype(np.float32)
  return sps.from_scipy(ss.csr_matrix((data, cols, indptr), shape=(n, m)))


def _check_skewed(S, B):
  indptr, indices, data = S.to_csr()
  before = dict(K5.counts)
  got = K5.spmm_csr(indptr, indices, data, B)
  torch.cuda.synchronize()
  assert K5.counts["launches"] == before["launches"] + 1
  assert K5.counts["plain_runs"] == before["plain_runs"]
  want = K5.spmm_csr_plain(indptr, indices, data, B)
  assert got.dtype == want.dtype and got.shape == want.shape
  diff = (got.double() - want.double()).abs()
  assert bool((diff <= _spmm_tolerance(indptr, indices, data, B)).all())
  assert torch.equal(got, K5.spmm_csr(indptr, indices, data, B))
  return got


@pytest.mark.parametrize("k", [1, 3, 4, 31, 64, 130, 512])
def test_spmm_kernel_splits_long_rows(device, k):
  S = _skewed_csr(device)
  gen = torch.Generator(device=device).manual_seed(53 + k)
  _check_skewed(S, torch.randn(S.shape[1], k, generator=gen, device=device))


@pytest.mark.parametrize("dropped", ["after_32_partials", "last_segment"])
def test_spmm_tolerance_rejects_a_row_missing_segments(device, dropped):
  # the 70,000-entry row without its partial rows after the first 32 (one
  # step of pass 2 at k = 64), or without its last segment, fails the check
  S = _skewed_csr(device)
  indptr, indices, data = S.to_csr()
  gen = torch.Generator(device=device).manual_seed(67)
  B = torch.randn(S.shape[1], 64, generator=gen, device=device)
  got = _check_skewed(S, B)
  r, s, e = 1500, int(indptr[1500]), int(indptr[1501])
  assert e - s == 70_000
  lo = (s + 33 * K5.SEG if dropped == "after_32_partials"
        else s + (e - s - 1) // K5.SEG * K5.SEG)
  bad = got.double().clone()
  bad[r] -= (data[lo:e].double()[:, None]
             * B.double()[indices[lo:e].long()]).sum(0)
  diff = (bad - K5.spmm_csr_plain(indptr, indices, data, B).double()).abs()
  assert not bool((diff <= _spmm_tolerance(indptr, indices, data, B)).all())


@pytest.mark.parametrize("form", ["bfloat16", "float16", "float64",
                                  "transposed", "unaligned"])
def test_spmm_kernel_splits_long_rows_for_each_b(device, form):
  S = _skewed_csr(device)
  gen = torch.Generator(device=device).manual_seed(59)
  B = torch.randn(S.shape[1], 64, generator=gen, device=device)
  if form == "transposed":
    got = _check_skewed(S, B.t().contiguous().t())
  elif form == "unaligned":  # a view 4 bytes into its storage
    flat = torch.cat([torch.zeros(1, device=device), B.flatten()])
    got = _check_skewed(S, flat[1:].view(B.shape))
  else:
    got = _check_skewed(S, B.to(getattr(torch, form)))
  if form in ("transposed", "unaligned"):
    # the order of the sums follows k alone, not B's layout
    assert torch.equal(got, K5.spmm_csr(*S.to_csr(), B))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sharded_spmm_equals_unsharded_on_long_rows(device, p):
  S = _skewed_csr(device)
  mesh = sp.make_mesh(shape=(p,))
  packed = S.to_windowed_spmm_sharded(p)
  full = sum(packed.rows(d)[1] > packed.rows(d)[0] for d in range(p))
  assert full == p
  gen = torch.Generator(device=device).manual_seed(61)
  for k in (3, 64, 512):
    B = torch.randn(S.shape[1], k, generator=gen, device=device)
    before = dict(K5.counts)
    got = K5.sharded_windowed_spmm_traced(packed, B, mesh)
    torch.cuda.synchronize()
    assert K5.counts["sharded_launches"] == before["sharded_launches"] + p
    assert K5.counts["sharded_plain_runs"] == before["sharded_plain_runs"]
    assert torch.equal(got, K5.spmm_csr(*S.to_csr(), B))


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


# -- matrix product K2 (matmul) -------------------------------------------------
# Tolerance: both sides sum the same K exact products in float32 in another
# order, so the float32 results differ by d <= 2·K·2^-24·(|x| @ |y|);
# tensor cores may truncate inside their adds, so the bound is doubled.  On
# these random-signed inputs the rounding errors add like a random walk, and
# d <= STAT_C·sqrt(K)·2^-24·sqrt(x² @ y²) holds too (chip_smoke.py's
# constant, about three times the largest share it reads at 32768^2); d is
# the smaller of the two.  A 16-bit output rounds each side once more:
# 2u·(|plain| + d) on top (u = 2^-8, 2^-11).

from spartan_tpu_torch.backend.kernels import matmul as K2  # noqa: E402

MATMUL_SHAPES = [(1, 1, 1), (17, 33, 65), (1000, 1001, 999), (64, 256, 128),
                 (130, 0, 70),
                 # a full 128 x 256 tile of the 16-bit kernel; ragged last
                 # tiles in M and in N; K of 64·s ± 1 (its stage depth)
                 (128, 64, 256), (129, 128, 257), (300, 191, 520),
                 (256, 193, 512), (257, 255, 250)]
OUT_UNIT = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}


def _relu(acc):
  return torch.clamp_min(acc, 0.0)


def _matmul_tol(x, y, want):
  xf, yf = x.float(), y.float()
  d = _sum_bound(x.shape[1], xf.abs() @ yf.abs(), xf.square() @ yf.square(),
                 4.0)
  return d + 2.0 * OUT_UNIT[x.dtype] * (want.float().abs() + d)


@pytest.mark.parametrize("epilogue", [None, _relu], ids=["none", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("mkn", MATMUL_SHAPES, ids=str)
def test_matmul_kernel_matches_plain(device, mkn, dtype, epilogue):
  m, k, n = mkn
  gen = torch.Generator(device=device).manual_seed(m + k + n)
  x = torch.randn(m, k, generator=gen, device=device).to(dtype)
  y = torch.randn(k, n, generator=gen, device=device).to(dtype)
  before = dict(K2.counts)
  got = K2.matmul(x, y, epilogue=epilogue)
  torch.cuda.synchronize()
  # an operand whose rows are not a multiple of 16 bytes is padded (TMA
  # reads both in every dtype)
  per16 = 16 // x.element_size()
  padded = (k > 0) * ((k % per16 != 0) + (n % per16 != 0))
  assert K2.counts == dict(before, launches=before["launches"] + 1,
                           padded_operands=before["padded_operands"] + padded)
  want = K2.matmul_plain(x, y, epilogue)
  assert got.dtype == want.dtype == dtype and got.shape == (m, n)
  diff = (got.float() - want.float()).abs()
  assert bool((diff <= _matmul_tol(x, y, want)).all())
  assert torch.equal(got, K2.matmul(x, y, epilogue=epilogue))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_matmul_epilogues_with_mod_and_power(device, dtype):
  """K2's epilogue takes ``%`` and ``**``.  float32: against torch's op on
  the kernel's own product, bit for bit for ``%`` and within 2 ulps for
  ``**`` (powf on both sides; torch may take another path).  Both dtypes:
  against matmul_plain at the product's bound carried through the op
  (``%``: the distance on the circle of the modulus)."""
  gen = torch.Generator(device=device).manual_seed(17)
  x = torch.randn(300, 191, generator=gen, device=device).to(dtype)
  y = torch.randn(191, 520, generator=gen, device=device).to(dtype)
  mod = lambda a: a % 2.0  # noqa: E731
  pw = lambda a: torch.abs(a) ** 1.5  # noqa: E731
  before = dict(K2.counts)
  got_mod = K2.matmul(x, y, epilogue=mod)
  got_pow = K2.matmul(x, y, epilogue=pw)
  assert K2.counts["epilogue_unfused"] == before["epilogue_unfused"]
  prod = K2.matmul_plain(x, y)
  tol = _matmul_tol(x, y, prod).float()
  want_mod, want_pow = K2.matmul_plain(x, y, mod), K2.matmul_plain(x, y, pw)
  d = (got_mod.float() - want_mod.float()).abs()
  d = torch.minimum(d, 2.0 - d)
  unit = max(OUT_UNIT[dtype], 2.0 ** -23)
  assert bool((d <= tol + 2.0 * unit * 2.0).all())
  base = prod.float().abs()
  pow_tol = 1.5 * (base + tol).sqrt() * tol + 4 * unit * want_pow.float().abs()
  assert bool(((got_pow.float() - want_pow.float()).abs() <= pow_tol).all())
  if dtype == torch.float32:
    own = K2.matmul(x, y)
    assert torch.equal(got_mod, torch.remainder(own, 2.0))
    torch.testing.assert_close(got_pow, torch.abs(own) ** 1.5, rtol=2.4e-7,
                               atol=0)


def test_matmul_unfused_epilogue_and_plain_routes(device):
  x = torch.randn(70, 90, device=device)
  y = torch.randn(90, 50, device=device)
  before = dict(K2.counts)
  got = K2.matmul(x, y, epilogue=torch.tanh)
  # K = 90 and N = 50 are not multiples of 4: TMA reads both padded
  assert K2.counts == dict(before, launches=before["launches"] + 1,
                           epilogue_unfused=before["epilogue_unfused"] + 1,
                           padded_operands=before["padded_operands"] + 2)
  want = K2.matmul_plain(x, y, torch.tanh)
  assert bool(((got - want).abs() <= _matmul_tol(x, y, want)).all())
  # dtypes off the kernel's list run on it in float32, as matmul_plain does
  for a, b in ((x.double(), y.double()), (x.half(), y), (x, y.bfloat16())):
    got = K2.matmul(a, b, epilogue=_relu)
    want = K2.matmul_plain(a, b, _relu)
    assert got.dtype == want.dtype == a.dtype
    tol = _matmul_tol(a.float(), b.float(), want.float())
    if a.dtype == torch.float16:  # the float32 result rounds to float16
      tol = tol + 2.0 * OUT_UNIT[a.dtype] * (want.float().abs() + tol)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
  assert K2.counts == dict(before, launches=before["launches"] + 4,
                           epilogue_unfused=before["epilogue_unfused"] + 1,
                           padded_operands=before["padded_operands"] + 8)


def test_matmul_reads_views_and_block_sizes_are_ignored(device):
  x = torch.randn(300, 200, device=device)[:, 7:150]
  y = torch.randn(160, 90, device=device).t()[:, :143].t()
  got = K2.matmul(x, y, bm=8, bn=128, bk=128)
  want = K2.matmul_plain(x.contiguous(), y.contiguous())
  assert bool(((got - want).abs() <= _matmul_tol(x, y, want)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_matmul_pads_what_tma_cannot_read(device, dtype):
  """A misaligned base or a row of a length not a multiple of 16 bytes is
  copied into an aligned, zero-padded buffer first (counted once an
  operand); the product is the one of the operands as they are."""
  gen = torch.Generator(device=device).manual_seed(11)
  flat = torch.randn(300 * 136 + 8, generator=gen, device=device).to(dtype)
  y = torch.randn(136, 264, generator=gen, device=device).to(dtype)
  cases = ((flat[:300 * 136].view(300, 136), y, 0),       # TMA reads both
           (flat[1:1 + 300 * 136].view(300, 136), y, 1),  # x 2 bytes off
           (flat[:300 * 136].view(300, 136), y[:, :263], 1),  # N = 263
           (flat[:300 * 135].view(300, 135), y[:135, :259], 2))
  for x, yy, padded in cases:
    before = dict(K2.counts)
    got = K2.matmul(x, yy, epilogue=_relu)
    again = K2.matmul(x, yy, epilogue=_relu)
    torch.cuda.synchronize()
    assert K2.counts == dict(before, launches=before["launches"] + 2,
                             padded_operands=before["padded_operands"]
                             + 2 * padded)
    want = K2.matmul_plain(x, yy, _relu)
    assert bool(((got.float() - want.float()).abs()
                 <= _matmul_tol(x, yy, want)).all())
    assert torch.equal(got, again)


# The float32 kernel at the edges: every M, N from EDGE_SIZES (around its
# 128 x 256 tile and 32-deep stage) with every K of EDGE_SIZES and K = 0,
# both epilogue variants, held to _matmul_tol and bit-equal on repeat; x or
# y with rows not a multiple of 16 bytes (K or N not a multiple of 4) is
# padded, counted.
EDGE_SIZES = (1, 3, 127, 129, 255, 257, 1000)


@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("m", EDGE_SIZES)
def test_matmul_float32_edges(device, m, n):
  gen = torch.Generator(device=device).manual_seed(7 * m + n)
  for k in EDGE_SIZES + (0,):
    x = torch.randn(m, k, generator=gen, device=device)
    y = torch.randn(k, n, generator=gen, device=device)
    for epilogue in (None, _relu):
      before = dict(K2.counts)
      got = K2.matmul(x, y, epilogue=epilogue)
      again = K2.matmul(x, y, epilogue=epilogue)
      torch.cuda.synchronize()
      padded = 2 * (k > 0) * ((k % 4 != 0) + (n % 4 != 0))
      assert K2.counts == dict(before, launches=before["launches"] + 2,
                               padded_operands=before["padded_operands"]
                               + padded), (m, k, n)
      want = K2.matmul_plain(x, y, epilogue)
      assert got.shape == (m, n) and got.dtype == torch.float32
      assert bool(((got - want).abs() <= _matmul_tol(x, y, want)).all()), (
          m, k, n, epilogue)
      assert torch.equal(got, again), (m, k, n, epilogue)


@pytest.mark.parametrize("view", ["sliced", "transposed"])
def test_matmul_float32_reads_a_noncontiguous_x(device, view):
  gen = torch.Generator(device=device).manual_seed(3)
  base = torch.randn(400, 300, generator=gen, device=device)
  x = base[:, 5:262] if view == "sliced" else base.t()[:, :257]
  assert not x.is_contiguous()
  y = torch.randn(x.shape[1], 129, generator=gen, device=device)
  got = K2.matmul(x, y, epilogue=_relu)
  want = K2.matmul_plain(x.contiguous(), y, _relu)
  assert bool(((got - want).abs() <= _matmul_tol(x, y, want)).all())
  assert torch.equal(got, K2.matmul(x, y, epilogue=_relu))


def test_matmul_float32_takes_more_than_65535_tiles_of_rows(device):
  """Past 65535 · 128 rows, where one block a 128-row tile in gridDim.y
  stopped: the tiles are a 1-D walk."""
  gen = torch.Generator(device=device).manual_seed(5)
  x = torch.randn(8_400_000, 4, generator=gen, device=device)
  y = torch.randn(4, 4, generator=gen, device=device)
  got = K2.matmul(x, y)
  want = K2.matmul_plain(x, y)
  assert bool(((got - want).abs() <= _matmul_tol(x, y, want)).all())


# -- unique-rows SpMV K3c (spmv_chunked) and make_spmv_windowed -----------------
# Tolerance per row: the smaller of 2·len(row)·2^-24·Σ|a·x| (float32 sums
# of the same products in another order) and the random-walk bound
# STAT_C·sqrt(len)·2^-24·sqrt(Σ(a·x)²), plus one rounding to x's dtype.


def _chunk_matrix(kind):
  import scipy.sparse as ss
  rng = np.random.default_rng(11)
  if kind == "nnz0":
    return ss.csr_matrix((50, 40), dtype=np.float32)
  if kind == "below_one_chunk":
    return ss.random(40, 50, density=0.15, random_state=1, format="csr",
                     dtype=np.float32)
  if kind == "row_on_chunk_boundary":
    lengths = np.array([512, 512, 1024, 256, 768, 1024, 3])
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = rng.integers(0, 3000, indptr[-1]).astype(np.int32)
    data = rng.standard_normal(indptr[-1]).astype(np.float32)
    return ss.csr_matrix((data, indices, indptr), shape=(len(lengths), 3000))
  if kind == "empty_rows_at_both_ends":
    A = ss.random(300, 700, density=0.05, random_state=2, format="lil",
                  dtype=np.float32)
    A[:100, :] = 0
    A[200:, :] = 0
    return A.tocsr()
  if kind == "row_longer_than_10_chunks":
    A = ss.random(64, 20000, density=0.001, random_state=3, format="lil",
                  dtype=np.float32)
    A[7, rng.choice(20000, 12_000, replace=False)] = rng.standard_normal(
        12_000).astype(np.float32)
    A[8, rng.choice(20000, 15_000, replace=False)] = rng.standard_normal(
        15_000).astype(np.float32)
    return A.tocsr()
  if kind == "empty_row_runs_inside_chunks":
    return ss.random(200_000, 500, density=2e-5, random_state=4, format="csr",
                     dtype=np.float32)
  if kind == "heavy_duplicates":
    B = ss.lil_matrix((1100, 1100), dtype=np.float32)
    B[5, 0:200] = rng.standard_normal(200)
    B[5, 1024:1060] = rng.standard_normal(36)
    return B.tocsr()
  if kind == "skewed_four_windows":
    # a scaled-down ML-20M R.T: power-law row lengths over 100,000 columns
    n, m = 300, 100_000
    lengths = np.maximum((9000 * np.arange(1, n + 1) ** -0.9).astype(int), 1)
    rows = np.repeat(np.arange(n), lengths)
    cols = np.minimum((rng.pareto(1.2, rows.size) * 4000).astype(np.int64),
                      m - 1)
    A = ss.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, m)).tocsr()
    A.sum_duplicates()
    return A
  n, m = 3000, 2500  # tests/test_kernels.py's unique-pack matrix
  r, c = rng.integers(0, n, n * 9), rng.integers(0, m, n * 9)
  v = rng.standard_normal(n * 9).astype(np.float32)
  A = ss.coo_matrix((v, (r, c)), shape=(n, m)).tocsr()
  A.sum_duplicates()
  return A


CHUNK_MATRICES = ["nnz0", "below_one_chunk", "row_on_chunk_boundary",
                  "empty_rows_at_both_ends", "row_longer_than_10_chunks",
                  "empty_row_runs_inside_chunks", "heavy_duplicates",
                  "random_duplicates_summed", "skewed_four_windows"]


def _row_tol(packed, x, want):
  """The per-row bound: the smaller of the worst case and the random walk
  over each row's products, plus one rounding to x's dtype."""
  lengths = (packed.indptr[1:] - packed.indptr[:-1]).float()
  csr = packed.indptr, packed.indices
  sum_abs = KS.spmv_csr_plain(*csr, packed.data.abs(), x.float().abs())
  sum_sq = KS.spmv_csr_plain(*csr, packed.data.square(), x.float().square())
  return (_sum_bound(lengths, sum_abs, sum_sq, 2.0)
          + OUT_UNIT[x.dtype] * want.float().abs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("kind", CHUNK_MATRICES)
def test_spmv_chunked_matches_plain_and_repeats_bit_for_bit(device, kind,
                                                            dtype):
  A = _chunk_matrix(kind)
  packed = KS.pack_windowed_unique(A)
  assert packed.indptr.device == device
  gen = torch.Generator(device=device).manual_seed(3)
  x = torch.randn(A.shape[1], generator=gen, device=device).to(dtype)
  args = (packed.indptr, packed.indices, packed.data, packed.chunk_row, x)
  before = dict(KS.counts)
  got = KS.spmv_chunked(*args)
  again = KS.spmv_chunked(*args)
  torch.cuda.synchronize()
  launched = 0 if A.nnz == 0 else 2
  assert KS.counts == dict(
      before, chunked_launches=before["chunked_launches"] + launched)
  want = KS.spmv_chunked_plain(*args)
  assert got.dtype == want.dtype == dtype and got.shape == (A.shape[0],)
  assert torch.equal(got, again)
  tol = _row_tol(packed, x, want)
  assert bool(((got.float() - want.float()).abs() <= tol).all())
  if kind == "empty_rows_at_both_ends":
    assert not bool(got[:100].any()) and not bool(got[200:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("kind", CHUNK_MATRICES[1:])
def test_windowed_spmv_chunked_matches_plain_and_repeats_bit_for_bit(
    device, kind, dtype):
  """K3c's windowed form (x's windows in shared memory) on the same
  matrices, one to four windows; the unwindowed form's result is held to
  the same bound."""
  A = _chunk_matrix(kind)
  packed = KS.pack_windowed_unique(A)
  assert packed.windows is not None
  assert packed.windows.count == -(-A.shape[1] // KS.WINDOW)
  gen = torch.Generator(device=device).manual_seed(5)
  x = torch.randn(A.shape[1], generator=gen, device=device).to(dtype)
  args = (packed.indptr, packed.indices, packed.data, packed.chunk_row, x)
  before = dict(KS.counts)
  got = KS.spmv_chunked(*args, packed.windows)
  again = KS.spmv_chunked(*args, packed.windows)
  torch.cuda.synchronize()
  assert KS.counts == dict(
      before, chunked_launches=before["chunked_launches"] + 2,
      chunked_windowed_launches=before["chunked_windowed_launches"] + 2)
  assert torch.equal(got, again)
  want = KS.spmv_chunked_plain(*args)
  assert got.dtype == dtype and got.shape == (A.shape[0],)
  tol = _row_tol(packed, x, want)
  assert bool(((got.float() - want.float()).abs() <= tol).all())
  unwindowed = KS.spmv_chunked(*args)
  assert bool(((unwindowed.float() - want.float()).abs() <= tol).all())
  if packed.windows.count == 1:
    # one window: the same chunks as the CSR's, summed in the same order
    assert torch.equal(got, unwindowed)


@pytest.mark.parametrize("kind", ["random_duplicates_summed",
                                  "row_longer_than_10_chunks"])
def test_make_spmv_windowed_routes_by_pack(device, kind):
  A = _chunk_matrix(kind)
  x = torch.randn(A.shape[1], device=device)
  x64 = x.double().cpu().numpy()
  want = A.astype(np.float64) @ x64
  # a float32 sum of len(row) products against float64: len·2^-24·Σ|a·x|
  tol = A.getnnz(1) * 2.0 ** -24 * (abs(A).astype(np.float64) @ np.abs(x64))
  for pack, keys in ((KS.pack_windowed, ("csr_launches",)),
                     (KS.pack_windowed_unique,
                      ("chunked_launches", "chunked_windowed_launches"))):
    fn = KS.make_spmv_windowed(pack(A))
    before = dict(KS.counts)
    got = fn(x)
    assert KS.counts == dict(before, **{k: before[k] + 1 for k in keys})
    assert got.dtype == torch.float32
    assert bool((np.abs(got.double().cpu().numpy() - want) <= tol).all())
    with pytest.raises(NotImplementedError):
      fn(x.double())


def test_spmv_chunked_from_a_sparse_array(device):
  # held to the float64 product: the plain version's own float32 sum (an
  # index_add on the card) of the row of 10,000 entries strays by more
  # than this bound, the kernel's does not
  A = _matrix("long_row")
  S = sps.from_scipy(A)
  gen = torch.Generator(device=device).manual_seed(9)
  x = torch.randn(S.shape[1], generator=gen, device=device)
  got = KS.make_spmv_windowed(KS.pack_windowed_unique(S))(x)
  want = torch.from_numpy(A.astype(np.float64) @ x.double().cpu().numpy())
  assert float((got.double().cpu() - want).abs().max()) <= 1e-5 * float(
      want.abs().max())


# -- shuffle, k-means and logistic regression on the card -----------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_shuffle_scatter_add_repeats_bit_for_bit(device, dtype):
  """2^20 values into 16 bins: index_put_(accumulate=True) sorts the
  indices and sums each bin in a fixed order on the card."""
  rng = np.random.default_rng(12)
  vals = rng.standard_normal(1 << 20).astype(dtype)
  bins = rng.integers(0, 16, 1 << 20)
  sv, sb = sp.from_numpy(vals), sp.from_numpy(bins)

  def once():
    return sp.shuffle([sv, sb], lambda v, b, c: ((b,), v), target_shape=(16,),
                      reducer=np.add).glom()

  first = once()
  assert all(np.array_equal(first, once()) for _ in range(3))
  want = np.zeros(16)
  np.add.at(want, bins, vals.astype(np.float64))
  # a sum of a bin's m random-signed terms in any order: its rounding errors
  # add like a random walk, about sqrt(m)·u·sqrt(Σv²) a bin; 16 times that
  # (the worst case (m - 1)·u·Σ|v| is about 3,000 times looser here).  In float32
  # that is 0.06 a bin, so one dropped value (|v| about 1) fails, and the
  # bins' sums, about sqrt(m) = 256 in size, are far from zero.
  count = np.bincount(bins, minlength=16)
  sum_sq = np.bincount(bins, vals.astype(np.float64) ** 2, 16)
  unit = 2.0 ** -24 if dtype == np.float32 else 2.0 ** -53
  tol = 16.0 * np.sqrt(count) * unit * np.sqrt(sum_sq)
  assert bool((np.abs(first - want) <= tol).all())
  assert bool((np.abs(want) > 1e3 * tol).any())
  assert bool((np.abs(first) > 1e3 * tol).any())


@pytest.mark.parametrize("reducer, init", [(np.maximum, -np.inf),
                                           (np.minimum, np.inf),
                                           (np.multiply, 1.0), (None, 0.0)],
                         ids=["max", "min", "mul", "set"])
def test_shuffle_reducers_on_card(device, reducer, init):
  rng = np.random.default_rng(13)
  vals = rng.uniform(0.5, 1.5, 4096)
  idx = rng.permutation(4096)[:1000] if reducer is None else (
      rng.integers(0, 64, 4096))
  vals = vals[:len(idx)]
  got = sp.shuffle([sp.from_numpy(vals), sp.from_numpy(idx)],
                   lambda v, i, c: ((i,), v),
                   target_shape=(4096 if reducer is None else 64,),
                   reducer=reducer, init=init).glom()
  want = np.full(got.shape, init)
  if reducer is None:
    want[idx] = vals
  else:
    reducer.at(want, idx, vals)
  np.testing.assert_allclose(got, want, rtol=1e-13)


def test_kmeans_and_logistic_regression_on_card(device):
  from spartan_tpu_torch.examples import kmeans, logistic_reg
  pts, true_c = kmeans.make_data(n=8192, d=8, k=6, seed=3)
  c0 = true_c + 0.3
  P = pts.glom()
  c = c0.copy()
  for _ in range(5):
    lab = np.argmin((c * c).sum(1) - 2.0 * (P @ c.T), axis=1)
    onehot = (lab[:, None] == np.arange(6)).astype(np.float64)
    c = (onehot.T @ P) / np.maximum(onehot.sum(0), 1.0)[:, None]
  for use_matmul in (True, False):
    cc = sp.from_numpy(c0)
    for _ in range(5):
      labels = kmeans.assign_labels(pts, cc)
      cc = sp.Val(kmeans.update_centers(pts, labels, 6, use_matmul=use_matmul)
                  .evaluate())
    np.testing.assert_array_equal(labels.glom(), lab)
    np.testing.assert_allclose(cc.glom(), c, rtol=1e-10)
  fused = kmeans.fit_fused(pts, 6, 5, centers=c0)
  assert fused.device.type == "cuda"
  np.testing.assert_allclose(fused.glom(), c, rtol=1e-10)
  X, y, _ = logistic_reg.make_data(4096, 8, seed=2)
  Xh, yh = X.glom(), y.glom()
  w = np.zeros(8)
  for _ in range(20):
    w = w - (Xh.T @ (1.0 / (1.0 + np.exp(-(Xh @ w))) - yh)) / 4096
  np.testing.assert_allclose(logistic_reg.fit_fused(X, y, 20).glom(), w,
                             rtol=1e-10)


# -- the sharded kernels: K3a sharded, K3d, K5b and K6b --------------------------
# Tolerance: each sharded entry point equals its unsharded kernel bit for
# bit (a row, or a stencil output, is the same sum in the same order
# whichever band holds it); K6b equals its plain version bit for bit in
# float32, as K6a does.

from spartan_tpu_torch.backend.kernels import spmm as K5S  # noqa: E402
from spartan_tpu_torch.backend.kernels import stencil as K6S  # noqa: E402


@pytest.mark.parametrize("with_add", [False, True], ids=["no_add", "add"])
@pytest.mark.parametrize("coeffs", sorted(STENCIL_COEFFS))
@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=str)
def test_k6b_halo_rows_match_plain(device, shape, coeffs, with_add):
  gen = torch.Generator(device=device).manual_seed(31)
  n, m = shape
  cs = STENCIL_COEFFS[coeffs]
  xp = K6S.to_padded(torch.randn(shape, generator=gen, device=device))
  add = (K6S.to_padded(torch.randn(shape, generator=gen, device=device))
         if with_add else None)
  top, bot = (torch.randn(m + 2 * K6S.PAD_C, generator=gen, device=device)
              for _ in range(2))
  buf = torch.full_like(xp, float("nan"))
  before = dict(K6S.counts)
  got, _ = K6S.stencil3x3_padded(xp, buf, cs, 1, add, top, bot)
  torch.cuda.synchronize()
  assert K6S.counts["k6b_launches"] == before["k6b_launches"] + 1
  assert K6S.counts["k6a_launches"] == before["k6a_launches"]
  want, _ = K6S.stencil3x3_padded_plain(xp, torch.zeros_like(xp), cs, 1, add,
                                        top, bot)
  assert torch.equal(K6S.from_padded(got), K6S.from_padded(want))
  ring = got.clone()
  ring[K6S.PAD_R:-K6S.PAD_R, K6S.PAD_C:-K6S.PAD_C] = float("nan")
  assert bool(ring.isnan().all())  # the ring of buf is never written


@pytest.mark.parametrize("p", [3, 8])
def test_sharded_stencil_equals_k6a(device, p):
  gen = torch.Generator(device=device).manual_seed(37)
  x = torch.randn((240, 300), generator=gen, device=device)
  g = torch.randn(x.shape, generator=gen, device=device)
  for add in (None, g):
    whole = K6S.stencil3x3_padded_sharded(
        x, STENCIL_COEFFS["nine"], 5, sp.make_mesh(shape=(1,)), add)
    before = dict(K6S.counts)
    got = K6S.stencil3x3_padded_sharded(x, STENCIL_COEFFS["nine"], 5,
                                        sp.make_mesh(shape=(p,)), add)
    torch.cuda.synchronize()
    assert K6S.counts["k6b_launches"] == before["k6b_launches"] + 5 * p
    assert K6S.counts["plain_runs"] == before["plain_runs"]
    assert torch.equal(got, whole)
  with pytest.raises(ValueError, match="n %"):
    K6S.stencil3x3_padded_sharded(x[:-1], STENCIL_COEFFS["nine"], 1,
                                  sp.make_mesh(shape=(p,)))


@pytest.mark.parametrize("p", [3, 8])
def test_sharded_spmv_kernels_equal_unsharded(device, p):
  import scipy.sparse as ss
  gen = torch.Generator(device=device).manual_seed(41)
  mesh = sp.make_mesh(shape=(p,))
  for kind in MATRICES + ["tall"]:
    A = (ss.random(20000, 3000, density=0.002, random_state=9, format="csr",
                   dtype=np.float32) if kind == "tall" else _matrix(kind))
    S = sps.from_scipy(A)
    x = torch.randn(A.shape[1], generator=gen, device=device)
    before = dict(KS.counts)
    got = KS.sharded_onehot_spmv(S.cols, S.vals, x, mesh)
    torch.cuda.synchronize()
    n = A.shape[0]
    bands = -(-n // -(-n // p))  # non-empty bands of ceil(n/p) rows
    # one launch over the table of all bands
    assert KS.counts["sharded_ell_launches"] == (
        before["sharded_ell_launches"] + 1)
    assert KS.counts["sharded_ell_bands"] == (
        before["sharded_ell_bands"] + bands)
    assert torch.equal(got, KS.spmv_ell(S.cols, S.vals, x))
    packed = S.to_windowed_sharded(p)
    full = sum(packed.rows(d)[1] > packed.rows(d)[0] for d in range(p))
    before = dict(KS.counts)
    got = KS.sharded_windowed_spmv_traced(packed, x, mesh)
    torch.cuda.synchronize()
    # one launch over the table of the non-empty bands
    assert KS.counts["sharded_csr_launches"] == (
        before["sharded_csr_launches"] + 1)
    assert KS.counts["sharded_csr_bands"] == (
        before["sharded_csr_bands"] + full)
    assert KS.counts["sharded_csr_plain_runs"] == before[
        "sharded_csr_plain_runs"]
    assert torch.equal(got, KS.spmv_csr(*S.to_csr(), x))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_k3d_is_one_launch_bit_equal_to_k3b(device, p):
  """K3d on a urand-like graph (random columns, mean degree 16) at the
  reference's row bands: one launch a call, bit-equal to K3b (the one-band
  table) and to itself on repeat, within the per-row bound of the plain
  version; with fewer rows than a shard's block the bands past the last
  row are left out."""
  import scipy.sparse as ss
  rng = np.random.default_rng(p)
  gen = torch.Generator(device=device).manual_seed(p)
  mesh = sp.make_mesh(shape=(p,))
  for n in (600, 300_000):
    A = ss.csc_matrix((np.full(16 * n, 1 / 16, np.float32),
                       rng.integers(0, n, 16 * n).astype(np.int32),
                       np.arange(0, 16 * n + 1, 16)), shape=(n, n)).tocsr()
    packed = KS.pack_windowed_sharded(A, p)
    whole = KS.pack_windowed(A)
    csr = (whole.indptr, whole.indices, whole.data)
    full = sum(packed.rows(d)[1] > packed.rows(d)[0] for d in range(p))
    x = torch.randn(n, generator=gen, device=device)
    before = dict(KS.counts)
    got = KS.sharded_windowed_spmv_traced(packed, x, mesh)
    again = KS.sharded_windowed_spmv_traced(packed, x, mesh)
    torch.cuda.synchronize()
    assert KS.counts == dict(
        before, sharded_csr_launches=before["sharded_csr_launches"] + 2,
        sharded_csr_bands=before["sharded_csr_bands"] + 2 * full)
    assert torch.equal(got, again)
    assert torch.equal(got, KS.spmv_csr(*csr, x))
    want = KS.spmv_csr_plain(*csr, x)
    assert bool(((got - want).abs() <= _row_tol(whole, x, want)).all())


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8, 64, 65])
def test_banded_k3a_equals_unsharded(device, p):
  """K3a sharded is one launch for every 64 non-empty bands, bit-equal to
  K3a; n < p leaves the shards past the last row out of the table."""
  import scipy.sparse as ss
  gen = torch.Generator(device=device).manual_seed(p)
  mesh = sp.make_mesh(shape=(p,))
  for n in (5, 100, 20000):
    A = ss.random(n, 3000, density=0.004, random_state=n, format="csr",
                  dtype=np.float32)
    S = sps.from_scipy(A)
    x = torch.randn(3000, generator=gen, device=device)
    bands = len(KS.ell_bands(n, p))
    before = dict(KS.counts)
    got = KS.sharded_onehot_spmv(S.cols, S.vals, x, mesh)
    torch.cuda.synchronize()
    assert KS.counts["sharded_ell_launches"] == (
        before["sharded_ell_launches"] + -(-bands // KS.MAX_BANDS))
    assert KS.counts["sharded_ell_bands"] == (
        before["sharded_ell_bands"] + bands)
    assert KS.counts["sharded_ell_plain_runs"] == before[
        "sharded_ell_plain_runs"]
    assert torch.equal(got, KS.spmv_ell(S.cols, S.vals, x))
    assert torch.equal(got, KS.sharded_onehot_spmv(S.cols, S.vals, x, mesh))


@pytest.mark.parametrize("p", [3, 8])
def test_sharded_spmm_kernel_equals_unsharded(device, p):
  import scipy.sparse as ss
  gen = torch.Generator(device=device).manual_seed(43)
  mesh = sp.make_mesh(shape=(p,))
  for kind in MATRICES + ["tall"]:
    A = (ss.random(5000, 3000, density=0.003, random_state=9, format="csr",
                   dtype=np.float32) if kind == "tall" else _matrix(kind))
    S = sps.from_scipy(A)
    packed = S.to_windowed_spmm_sharded(p)
    full = sum(packed.rows(d)[1] > packed.rows(d)[0] for d in range(p))
    for k in (1, 64, 130):
      B = torch.randn(A.shape[1], k, generator=gen, device=device)
      before = dict(K5S.counts)
      got = K5S.sharded_windowed_spmm_traced(packed, B, mesh)
      torch.cuda.synchronize()
      assert K5S.counts["sharded_launches"] == (
          before["sharded_launches"] + full)
      assert torch.equal(got, K5S.spmm_csr(*S.to_csr(), B))


def test_sharded_routes_launch_once_a_shard_on_card(device):
  import scipy.sparse as ss
  A = ss.random(40000, 40000, density=2e-4, random_state=12, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  x = np.random.default_rng(3).standard_normal(40000).astype(np.float32)
  want = KS.spmv_csr(*S.to_csr(), torch.from_numpy(x).to(device))
  with sp.with_mesh(sp.make_mesh(shape=(8,))):
    e = sps.spmv_expr(S, sp.from_numpy(x))
    assert e.fmt == "winsh" and e.n_shards == 8
    KS.reset_counts()
    got = e.glom()
    torch.cuda.synchronize()
    # 40 blocks of 1024 rows, 5 a shard: 8 shards, none empty, one launch
    assert KS.counts["sharded_csr_launches"] == 1
    assert KS.counts["sharded_csr_bands"] == 8
    assert KS.counts["csr_launches"] == KS.counts["csr_plain_runs"] == 0
  np.testing.assert_array_equal(got, want.cpu().numpy())


# -- faults found against the reference: integer dot, shuffle's drop ------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=str)
def test_integer_dot_and_tensordot_on_card(device, dtype):
  """torch has no integer matmul on CUDA: the exact route gives NumPy's
  result, wrapping included, and is counted."""
  from spartan_tpu_torch.expr import dot as D
  rng = np.random.default_rng(11)
  hi = 1 << 20 if dtype == np.int32 else 1 << 40
  a = rng.integers(-hi, hi, (37, 129)).astype(dtype)
  b = rng.integers(-hi, hi, (129, 23)).astype(dtype)
  D.reset_counts()
  got = sp.dot(sp.from_numpy(a), sp.from_numpy(b)).glom()
  assert got.dtype == dtype
  np.testing.assert_array_equal(got, a @ b)
  got_v = sp.dot(sp.from_numpy(a), sp.from_numpy(b[:, 0])).glom()
  np.testing.assert_array_equal(got_v, a @ b[:, 0])
  c = rng.integers(-9, 9, (4, 5, 6)).astype(dtype)
  d = rng.integers(-9, 9, (6, 5, 3)).astype(dtype)
  got_t = D.tensordot(sp.from_numpy(c), sp.from_numpy(d),
                      ([1, 2], [1, 0])).glom()
  np.testing.assert_array_equal(got_t, np.tensordot(c, d, ([1, 2], [1, 0])))
  assert D.counts["exact_int_route"] == 3


def test_shuffle_drops_out_of_range_updates_on_card(device):
  """An index out of range is dropped before the scatter; the CUDA context
  stays usable (a device-side assert would poison it)."""
  vals = np.array([1.0, 2.0, np.nan, 4.0, 5.0, -1.0])
  idx = np.array([0, 1, 1, 2, 7, -1])
  for reducer, want in ((np.add, [1.0, np.nan, 4.0, 0.0, -1.0]),
                        (np.maximum, [1.0, np.nan, 4.0, 0.0, 0.0]),
                        (np.minimum, [0.0, np.nan, 0.0, 0.0, -1.0]),
                        (np.multiply, [0.0, np.nan, 0.0, 0.0, -0.0])):
    got = sp.shuffle([sp.from_numpy(vals), sp.from_numpy(idx)],
                     lambda v, i, c: ((i,), v), target_shape=(5,),
                     reducer=reducer).glom()
    np.testing.assert_array_equal(got, want)
  got = sp.shuffle([sp.from_numpy(vals), sp.from_numpy(
      np.array([0, 1, 3, 2, 7, -6]))], lambda v, i, c: ((i,), v),
      target_shape=(5,), reducer=None).glom()
  np.testing.assert_array_equal(got, [1.0, 2.0, 4.0, np.nan, 0.0])
  got2 = sp.shuffle([sp.from_numpy(np.arange(1.0, 6.0))],
                    lambda v, c: ((torch.tensor([0, 0, 1, 2, 2],
                                                device=v.device),
                                   torch.tensor([5, 1, -1, -9, 3],
                                                device=v.device)), v),
                    target_shape=(3, 4), reducer=np.add).glom()
  np.testing.assert_array_equal(got2, [[0, 2, 0, 0], [0, 0, 0, 3],
                                       [0, 0, 0, 5]])
  torch.cuda.synchronize()
  assert float((torch.ones(1000, device=device) * 2).sum()) == 2000.0


# -- the expression surface on the card -----------------------------------------
# Slices, gathers, masks and .at updates against NumPy on a host copy:
# exact for copies, rtol 1e-9 for float64 sums; .at[...].add with
# duplicate indices uses atomics on the card, so its float bits vary from
# run to run: it is held to a float64 np.add.at of the same float32 values
# at 4 float32 ulps of each updated value.

from spartan_tpu_torch.expr import slice as slice_mod  # noqa: E402


def test_indexing_on_card(device):
  host = np.random.default_rng(8).standard_normal((700, 300)).astype(
      np.float32)
  b = sp.from_numpy(host)
  rows = np.random.default_rng(9).integers(0, 700, 257)
  cols = np.random.default_rng(10).integers(0, 300, 257)
  np.testing.assert_array_equal(b[1:-1, ::3].glom(), host[1:-1, ::3])
  np.testing.assert_array_equal(b[::-2, 5].glom(), host[::-2, 5])
  np.testing.assert_array_equal(b[rows].glom(), host[rows])
  np.testing.assert_array_equal(b[sp.from_numpy(rows), sp.from_numpy(cols)]
                                .glom(), host[rows, cols])
  before = slice_mod.counts["boolean_mask_device"]
  np.testing.assert_array_equal(b[b > 1.5].glom(), host[host > 1.5])
  assert slice_mod.counts["boolean_mask_device"] == before + 1
  np.testing.assert_allclose(float(b[1:-1, 1:-1].sum().glom()),
                             host[1:-1, 1:-1].astype(np.float64).sum(),
                             rtol=1e-9)


def test_at_add_with_duplicates_on_card(device):
  host = np.random.default_rng(11).standard_normal((500, 40)).astype(
      np.float32)
  rows = np.random.default_rng(12).integers(0, 500, 5000)
  cols = np.random.default_rng(13).integers(0, 40, 5000)
  got = sp.from_numpy(host).at[sp.from_numpy(rows),
                               sp.from_numpy(cols)].add(1.0).glom()
  want = host.astype(np.float64)
  np.add.at(want, (rows, cols), 1.0)
  np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -24,
                             atol=4 * 2.0 ** -24 * np.abs(want).max())
  m = sp.from_numpy(host).at[sp.from_numpy(rows)].max(
      sp.from_numpy(np.full((5000, 40), 0.5, np.float32))).glom()
  want_max = host.copy()
  np.maximum.at(want_max, rows, np.float32(0.5))
  np.testing.assert_array_equal(m, want_max)


def test_reductions_on_card(device):
  host = np.random.default_rng(14).uniform(0.5, 1.5, (300, 200)).astype(
      np.float32)
  host[3, 4] = np.nan
  b = sp.from_numpy(host)
  h64 = host.astype(np.float64)
  np.testing.assert_allclose(float(sp.nanmean(b).glom()), np.nanmean(h64),
                             rtol=1e-9)
  clean = sp.from_numpy(np.nan_to_num(host, nan=1.0))
  c64 = np.nan_to_num(h64, nan=1.0)
  np.testing.assert_allclose(float(sp.var(clean).glom()), np.var(c64),
                             rtol=1e-9)
  np.testing.assert_allclose(float(sp.std(clean, ddof=1).glom()),
                             np.std(c64, ddof=1), rtol=1e-9)
  np.testing.assert_allclose(clean[0:50].prod(axis=0).glom(),
                             c64[0:50].prod(axis=0), rtol=1e-9)
  assert bool(sp.all(clean > 0).glom()) and not bool(sp.any(clean > 2).glom())
