"""Card-only tests of the port: kernels K1 (csrc/fused_reduce.cu), K2
(csrc/matmul.cu), K3a (csrc/spmv_ell.cu), K3b (csrc/spmv_csr.cu), K3c
(csrc/spmv_chunked.cu), K5a (csrc/spmm_csr.cu), K4, K6a and K6b
(csrc/stencil3x3*.cu) against their plain torch versions on the same CUDA
tensors; the sharded entry points (K3a sharded, K3d, K5b, K6b) against
their unsharded kernels; the expression layer's, PageRank's, ALS's, the
stencil examples' and make_spmv_windowed's kernel paths; shuffle, integer
dot, k-means, logistic regression and the linear-algebra, statistics and
shape builtins (integer einsum's exact route among them), the sorts,
searches, order statistics and scans, and the loops (``while_loop``,
``scan_iters``, ``cond``) and the Krylov solvers of ``sp.sparse.linalg``
with their matvecs on K3a/K3b/K3d on the card; ``least_squares``,
``solve_ivp`` and ``differential_evolution`` with every evaluation on
cuda tensors and no host route; ``sp.signal``'s filter loops, ``sp.stats``'
betainc inverses and normal tail, a sign-bit NaN through ``medfilt``, and
the oscillator example; ``sp.ndimage``'s filters, loops and label, its
measurements' segment reductions against a float64 host oracle,
``KDTree.query``'s ties, ``cdist``'s chunked route and ``Rotation``.  Run on a machine with
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
  got = K2.matmul(x, y, epilogue=torch.sigmoid)
  # K = 90 and N = 50 are not multiples of 4: TMA reads both padded
  assert K2.counts == dict(before, launches=before["launches"] + 1,
                           epilogue_unfused=before["epilogue_unfused"] + 1,
                           padded_operands=before["padded_operands"] + 2)
  want = K2.matmul_plain(x, y, torch.sigmoid)
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


SLICE_RNG = np.random.default_rng(14)
SLICE_I = SLICE_RNG.integers(-1 << 20, 1 << 20, (6, 7)).astype(np.int64)
SLICE_F = SLICE_RNG.standard_normal((6, 7))
# the linear-algebra, statistics and shape builtins on the card: (the
# port's call over sp, NumPy's value)
SLICE_CASES = {
    "einsum_batch_int": (lambda m: m.einsum("bij,bjk->bik", SLICE_I[None],
                                            SLICE_I.T[None]),
                         lambda: np.einsum("bij,bjk->bik", SLICE_I[None],
                                           SLICE_I.T[None])),
    "einsum_diag_int": (lambda m: m.einsum("ii->i", SLICE_I[:6, :6]),
                        lambda: np.einsum("ii->i", SLICE_I[:6, :6])),
    "inner_int": (lambda m: m.inner(SLICE_I, SLICE_I),
                  lambda: np.inner(SLICE_I, SLICE_I)),
    "kron_int": (lambda m: m.kron(SLICE_I[:2, :3], SLICE_I[2:4, :2]),
                 lambda: np.kron(SLICE_I[:2, :3], SLICE_I[2:4, :2])),
    "convolve_int": (lambda m: m.convolve(SLICE_I[0], SLICE_I[1, :3]),
                     lambda: np.convolve(SLICE_I[0], SLICE_I[1, :3])),
    "take_along_negative": (lambda m: m.take_along_axis(
        m.from_numpy(SLICE_F), m.from_numpy(np.array([[-1, 0, -7]] * 6)), 1),
                            lambda: np.take_along_axis(
        SLICE_F, np.array([[-1, 0, -7]] * 6), 1)),
    "histogram": (lambda m: m.histogram(m.from_numpy(SLICE_F), 5),
                  lambda: np.histogram(SLICE_F, 5)[0]),
    "packbits_roundtrip": (lambda m: m.unpackbits(m.packbits(
        m.from_numpy(SLICE_F > 0), axis=1), axis=1, count=7),
                           lambda: (SLICE_F > 0).astype(np.uint8)),
    "pad_reflect_odd": (lambda m: m.pad(m.from_numpy(SLICE_F), (2, 9),
                                        "reflect", reflect_type="odd"),
                        lambda: np.pad(SLICE_F, (2, 9), "reflect",
                                       reflect_type="odd")),
    "concatenate_mixed": (lambda m: m.concatenate(
        [m.from_numpy(SLICE_I.astype(np.int32)), m.from_numpy(SLICE_F)], 1),
                          lambda: np.concatenate(
        [SLICE_I.astype(np.int32), SLICE_F], 1)),
}


@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_slice_builtins_on_card(device, name):
  """Integer contractions take the exact route on the card (torch's CUDA
  matmul has no integers); gathers wrap negative indices without a
  device-side assert; the rest as on the CPU, exactly."""
  call, want = SLICE_CASES[name]
  got = np.asarray(call(sp).glom())
  expected = want()
  assert got.dtype == expected.dtype
  np.testing.assert_array_equal(got, expected)


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


NEW_OP_CHAINS = {
    "sin": lambda v: call("sin", v), "tan": lambda v: call("tan", v),
    "tanh": lambda v: call("tanh", v),
    "floor": lambda v: call("floor", call("multiply", v,
                                            LocalConst(3.0))),
    "arctan2": lambda v: call("arctan2", v, LocalConst(0.5)),
    "hypot": lambda v: call("hypot", v, LocalConst(2.0)),
    "log1p": lambda v: call("log1p", call("absolute", v)),
    "erfc": lambda v: call("erfc", v),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", sorted(NEW_OP_CHAINS))
def test_k1_rare_ops_against_plain(device, name, dtype):
  """K1's rare variants against fused_sum_plain, at 1e-6 of the sum of
  |values| (CUDA's libm and this kernel's sin/cos/tan agree with torch's
  to an ulp an element) with a float64 sum."""
  gen = torch.Generator(device=device).manual_seed(5)
  x = (torch.rand(1_000_003, generator=gen, device=device) * 6 - 3).to(dtype)
  program = K.plan(NEW_OP_CHAINS[name](LocalInput(0)), 0, dtype, {})
  assert program is not None and K.has_rare(program)
  got = K.fused_sum(x, program, [], torch.float64).item()
  values = K.evaluate_program(program, x, [])
  want = torch.sum(values, dtype=torch.float64).item()
  scale = values.double().abs().sum().item()
  assert abs(got - want) <= 1e-6 * scale


@pytest.mark.parametrize("scale", [1e6, 1e30])
def test_k1_trig_past_the_fast_reduction(device, scale):
  """sin, cos and tan past |x| = 105615 (CUDA sinf's slow path) and up to
  1e30 within an ulp an element of float64."""
  gen = torch.Generator(device=device).manual_seed(6)
  x = torch.rand(1 << 20, generator=gen, device=device) * 2 - 1
  for name in ("sin", "cos", "tan"):
    chain = call(name, call("multiply", LocalInput(0), LocalConst(scale)))
    program = K.plan(chain, 0, torch.float32, {})
    got = K.fused_sum(x, program, [], torch.float64).item()
    arg = (x * scale).double()
    want_v = getattr(torch, name)(arg)
    assert abs(got - want_v.sum().item()) <= (
        2.0 ** -23 * want_v.abs().sum().item())


# Sorts, searches, order statistics and scans on the card (expr/sort_expr.py,
# expr/scan.py).  Orderings, searches and integer or max/min scans exactly
# against NumPy (argsorts against its stable argsort); float64 sums at
# 1e-10 relative; order statistics of float32 within one float32 ulp of
# NumPy's float64 values.

def _stress_keys(kind, n, seed):
  rng = np.random.default_rng(seed)
  if kind == "int32_ties":
    return rng.integers(0, 8, n).astype(np.int32)
  if kind == "signed_zeros":
    return rng.choice(np.array([-1.0, -0.0, 0.0, 1.0], np.float32), n)
  if kind == "nans":
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.random(n) < 0.05] = np.nan
    x[rng.random(n) < 0.05] = -np.nan  # the sign bit set
    x[rng.random(n) < 0.05] = -0.0
    return x
  x = rng.integers(0, 4, n).astype(np.float64)
  x[rng.random(n) < 0.1] = -np.nan
  return x


@pytest.mark.parametrize("n", [100, 5000, 1 << 20])
@pytest.mark.parametrize("kind", ["int32_ties", "signed_zeros", "nans",
                                  "float64_nans"])
def test_stable_argsort_on_card(device, kind, n):
  x = _stress_keys(kind, n, n)
  d = sp.from_numpy(x)
  want = np.argsort(x, kind="stable")
  np.testing.assert_array_equal(sp.argsort(d).glom(), want)
  got = sp.sort(d).glom()
  np.testing.assert_array_equal(got, x[want])  # NaN equal to NaN
  assert sp.argsort(d).glom().dtype == np.int64


@pytest.mark.parametrize("axis", [0, 1, None])
def test_sorts_along_axes_on_card(device, axis):
  x = _stress_keys("nans", 3000 * 700, 3).reshape(3000, 700)
  d = sp.from_numpy(x)
  np.testing.assert_array_equal(sp.argsort(d, axis=axis).glom(),
                                np.argsort(x, axis=axis, kind="stable"))
  np.testing.assert_array_equal(sp.sort(d, axis=axis).glom(),
                                np.sort(x, axis=axis))
  np.testing.assert_array_equal(sp.lexsort([d[0], d[1]]).glom(),
                                np.lexsort([x[0], x[1]]))


def test_unique_of_signed_nans_on_card(device):
  x = np.array([2.0, -np.nan, 1.0, np.nan, -0.0, 0.0, 2.0])
  np.testing.assert_array_equal(sp.unique(x).glom(), np.unique(x))


def test_scans_on_card(device):
  rng = np.random.default_rng(9)
  x = rng.standard_normal((513, 1000)).astype(np.float32)
  d = sp.from_numpy(x)
  for axis in (0, 1, None):
    got = sp.cumsum(d, axis=axis).glom()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.cumsum(x, axis=axis,
                                              dtype=np.float64),
                               rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(
      sp.cumprod(1 + 0.001 * d, axis=1).glom(),
      np.cumprod(1 + 0.001 * x, axis=1, dtype=np.float64), rtol=1e-10)
  xn = x.copy()
  xn[rng.random(xn.shape) < 0.002] = np.nan
  dn = sp.from_numpy(xn)
  for axis in (0, 1):
    np.testing.assert_array_equal(sp.cummax(dn, axis=axis).glom(),
                                  np.maximum.accumulate(xn, axis=axis))
    np.testing.assert_array_equal(sp.cummin(dn, axis=axis).glom(),
                                  np.minimum.accumulate(xn, axis=axis))
    np.testing.assert_allclose(sp.nancumsum(dn, axis=axis).glom(),
                               np.nancumsum(xn.astype(np.float64),
                                            axis=axis), rtol=1e-10,
                               atol=1e-10)
  i = rng.integers(-5, 6, (300, 40)).astype(np.int32)
  np.testing.assert_array_equal(sp.cumsum(i, axis=0).glom(),
                                np.cumsum(i, axis=0))
  u = rng.integers(0, 256, 1000).astype(np.uint8)
  np.testing.assert_array_equal(sp.cumsum(u).glom(),
                                np.cumsum(u).astype(np.int64))


def test_custom_scan_on_card(device):
  rng = np.random.default_rng(10)
  x = rng.standard_normal(1 << 16)
  d = sp.from_numpy(x)
  np.testing.assert_array_equal(sp.scan(d, scan_fn=torch.maximum).glom(),
                                np.maximum.accumulate(x))
  got = sp.scan(d, scan_fn=torch.logaddexp, reverse=True).glom()
  want = np.logaddexp.accumulate(x[::-1])[::-1]
  np.testing.assert_allclose(got, want, rtol=2 * x.size * 2.0 ** -52)


def test_order_statistics_on_card(device):
  rng = np.random.default_rng(11)
  x = rng.standard_normal((257, 300)).astype(np.float32)
  xn = x.copy()
  xn[rng.random(x.shape) < 0.01] = np.nan
  xn[5] = np.nan
  d, dn = sp.from_numpy(x), sp.from_numpy(xn)
  x64, xn64 = x.astype(np.float64), xn.astype(np.float64)
  ulp = 2.0 ** -23
  cases = [
      (sp.median(d), np.median(x64)),
      (sp.median(d, axis=0), np.median(x64, axis=0)),
      (sp.percentile(d, [1, 50, 99], axis=1),
       np.percentile(x64, [1, 50, 99], axis=1)),
      (sp.quantile(d, 0.3), np.quantile(x64, 0.3)),
      (sp.median(dn, axis=1), np.median(xn64, axis=1)),
      (sp.nanmedian(dn), np.nanmedian(xn64)),
      (sp.nanpercentile(dn, [10, 90], axis=1),
       np.nanpercentile(xn64, [10, 90], axis=1)),
  ]
  for e, want in cases:
    got = np.asarray(e.glom())
    assert got.dtype == np.float32 and got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=ulp, atol=0)
  i = rng.integers(-50, 50, 1001).astype(np.int32)
  np.testing.assert_array_equal(sp.percentile(i, [0, 33, 100]).glom(),
                                np.percentile(i, [0, 33, 100]))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searches_on_card(device, side):
  rng = np.random.default_rng(12)
  bounds = np.sort(np.concatenate([rng.integers(-50, 50, 3000) / 4.0,
                                   [np.inf, np.nan, -np.nan]]))
  q = np.concatenate([rng.uniform(-15, 15, 20000), bounds[::7],
                      [np.nan, -np.nan, np.inf, -np.inf]])
  np.testing.assert_array_equal(
      sp.searchsorted(bounds, q, side=side).glom(),
      np.searchsorted(bounds, q, side=side))
  finite = np.unique(bounds[np.isfinite(bounds)])
  for bins in (finite, finite[::-1].copy()):
    for right in (False, True):
      np.testing.assert_array_equal(sp.digitize(q, bins, right).glom(),
                                    np.digitize(q, bins, right))


def test_permutation_and_choice_on_card(device):
  got = sp.permutation(1 << 20).glom()
  np.testing.assert_array_equal(np.sort(got), np.arange(1 << 20))
  c = sp.choice(1000, 300, replace=False).glom()
  assert len(set(c.tolist())) == 300 and c.min() >= 0 and c.max() < 1000


def test_complex_convolve_correlate_interp_on_card(device):
  rng = np.random.default_rng(13)
  a = rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
  v = rng.standard_normal(33) + 1j * rng.standard_normal(33)
  for name in ("convolve", "correlate"):
    for mode in ("valid", "same", "full"):
      want = getattr(np, name)(a, v, mode)
      got = getattr(sp, name)(a, v, mode).glom()
      np.testing.assert_allclose(got, want, rtol=0,
                                 atol=1e-13 * np.abs(want).max())
  xp = np.sort(rng.uniform(-2, 2, 50))
  xq = rng.uniform(-2.5, 2.5, 1000)
  np.testing.assert_array_equal(sp.interp(xq, xp, v[:1].repeat(50) * xp
                                          ).glom(),
                                np.interp(xq, xp, v[:1].repeat(50) * xp))


def test_sort_method_sample_raises_on_card(device):
  from spartan_tpu_torch.config import FLAGS
  FLAGS.sort_method = "sample"
  try:
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
      sp.sort(np.arange(8.0)).glom()
  finally:
    FLAGS.sort_method = "auto"


# -- the loops and the Krylov solvers (sp.sparse.linalg) ----------------------
# Tolerances: a float32 solve's float64 true residual on the host against
# the bound that its rtol (atol for lsqr/lsmr), its iterations and the
# system's norms fix (sparse_linalg._residual_bound and _normal_bound), and
# its x against the drawn xt at the bound those give through |A^-1|_2.  The
# square systems are strictly diagonally dominant with margin 1 by rows and
# by columns, so |A^-1|_2 <= 1 and |x|_2 <= |b|_2; the tall ones are
# [A; I], whose smallest singular value is at least sqrt(2).  b is rounded
# to float32, which moves the exact solution off xt by at most
# |A^-1|_2 eps32 |b|_2.  lstsq on the card against its CPU run at 1e-4 of
# max|y| (two float32 SVDs).

from spartan_tpu_torch import sparse_linalg as spl  # noqa: E402

EPS32 = 2.0 ** -24


def _solver_system(n, seed=2):
  """A float64 scipy matrix, diagonally dominant with margin 1: the
  reference test's ``_sparse_spd`` with a superdiagonal for the
  nonsymmetric solvers' use."""
  import scipy.sparse as ss
  g = ss.random(n, n, density=8.0 / n, random_state=np.random.default_rng(seed),
                format="csr")
  a = (g + g.T).tocsr()
  return (a + ss.diags(np.asarray(np.abs(a).sum(axis=1)).ravel() + 1.0)
          ).tocsr()


def _norm2_bound(a) -> float:
  """sqrt(|A|_1 |A|_inf), an upper bound of |A|_2."""
  a = abs(a)
  return float(np.sqrt(a.sum(axis=0).max() * a.sum(axis=1).max()))


def _hold_solve(name, A, b, xt, x, out, iters, kw):
  """x (float64 numpy) of a float32 solve of A x = b against the bounds
  fixed by the stopping rule in ``kw``, the iterations and A's norms."""
  a_norm, b_norm = _norm2_bound(A), np.linalg.norm(b)
  if name in ("lsqr", "lsmr"):
    atb = np.linalg.norm(A.T @ b)
    x_norm = np.linalg.norm(xt) + EPS32 * b_norm
    atol = kw["atol"]
    if name == "lsmr":
      # lsmr's |A| estimate after k steps is at most sqrt(2k + 1) |A|_2;
      # istop 1: |r| <= btol |b| + atol |A| |x|; istop 2: |A'r| <= atol |A|
      # |r|, with |r| <= |b|
      a_est = (2 * iters + 1) ** 0.5 * a_norm
      if out[1] == 1:
        atol = a_norm * (kw["btol"] * b_norm + atol * a_est * x_norm) / atb
      else:
        atol = atol * a_est * b_norm / atb
    bound = spl._normal_bound(atol, iters, a_norm, x_norm, b_norm, atb)
    normal = np.linalg.norm(A.T @ (b - A @ x)) / atb
    assert normal <= bound, (normal, bound)
    # |x - x_opt| <= |A'r| / s_min^2, |x_opt - xt| <= eps32 |b| / s_min
    err_bound = bound * atb / 2 + EPS32 * b_norm / 2 ** 0.5
  else:
    bound = spl._residual_bound(kw["rtol"], iters, a_norm, b_norm, b_norm)
    rel = np.linalg.norm(b - A @ x) / b_norm
    assert rel <= bound, (rel, bound)
    err_bound = (bound + EPS32) * b_norm
  assert np.linalg.norm(x - xt) <= err_bound * (1 + 1e-9)


def _run_counted(fn):
  """``fn()`` with the SpMV counts set to 0 before it; its result, the
  last while_loop's final carry and the counts after it."""
  KS.reset_counts()
  with spl._loops_run() as runs:
    out = fn()
    torch.cuda.synchronize()
  return out, runs[-1][0], dict(KS.counts)


@pytest.mark.parametrize("n, route", [(4096, "ell"), (40000, "csr")])
@pytest.mark.parametrize("name", sorted(spl._MATVECS))
def test_solver_matvecs_launch_the_kernels_on_card(device, name, n, route):
  import scipy.sparse as ss
  A = _solver_system(n)
  if name not in ("cg", "minres"):  # nonsymmetric, still margin 1
    A = (A + ss.diags([np.full(n, 0.5), np.full(n - 1, 0.5)], [0, 1])
         ).tocsr()
  xt = np.random.default_rng(5).standard_normal(A.shape[1])
  tall = name in ("lsqr", "lsmr")
  if tall:
    A = ss.vstack([A, ss.identity(n)]).tocsr()
  b = (A @ xt).astype(np.float32)
  S = sps.from_scipy(A.astype(np.float32))
  lin = sp.sparse.linalg
  if name in ("lsqr", "lsmr"):
    kw = {"atol": 1e-6} if name == "lsqr" else {"atol": 1e-6, "btol": 1e-6}
  else:
    kw = {"rtol": 1e-5}
  out, final, counts = _run_counted(lambda: getattr(lin, name)(S, b, **kw))
  iters = spl._iterations(name, final)
  per, extra = spl._MATVECS[name]
  assert counts[f"{route}_launches"] == per * iters + extra
  assert counts["ell_plain_runs"] == counts["csr_plain_runs"] == 0
  assert out[1] in ((1, 2) if name in ("lsqr", "lsmr") else (0,))
  x = out[0].data
  assert x.device.type == "cuda" and x.dtype == torch.float32
  _hold_solve(name, A, b.astype(np.float64), xt,
              x.cpu().numpy().astype(np.float64), out, iters, kw)


def test_sharded_cg_equals_unsharded_on_card(device):
  A = _solver_system(40000)
  b = (A @ np.ones(40000)).astype(np.float32)
  S = sps.from_scipy(A.astype(np.float32))
  x1, info1 = sp.sparse.linalg.cg(S, b, rtol=1e-5)
  with sp.with_mesh(sp.make_mesh(shape=(8,))):
    (x8, info8), _, counts = _run_counted(
        lambda: sp.sparse.linalg.cg(S, b, rtol=1e-5))
  assert counts["sharded_csr_launches"] > 0 and counts["csr_launches"] == 0
  assert info1 == info8 == 0
  assert torch.equal(x1.data, x8.data)


def test_loops_on_card(device):
  out = sp.while_loop(lambda c: sp.sum(c) < 10.0, lambda c: c + 1.0,
                      sp.zeros((2,)))
  assert out.data.device.type == "cuda"
  np.testing.assert_array_equal(out.glom(), [5.0, 5.0])
  assert float(sp.while_loop(lambda c: sp.sum(c) < 1e9, lambda c: c + 1.0,
                             sp.zeros(()), max_iters=7).glom()) == 7.0
  none = sp.while_loop(lambda c: sp.sum(c) > 1e9, lambda c: c + 1.0,
                       sp.ones((3,)))
  np.testing.assert_array_equal(none.glom(), [1.0, 1.0, 1.0])
  final, curve = sp.scan_iters(5, lambda c: c * 2.0, sp.ones(()))
  assert curve.data.device.type == "cuda"
  np.testing.assert_array_equal(curve.glom(), [2, 4, 8, 16, 32])
  a = sp.from_numpy(np.arange(4.0, dtype=np.float32))
  for limit, want in ((1.0, np.arange(4.0) * 2), (100.0, np.arange(4.0) / 2)):
    got = sp.cond(sp.sum(a) > limit, lambda x: x * 2.0, lambda x: x * 0.5, a)
    assert got.data.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.glom(), want)


@pytest.mark.parametrize("rank", [7, 20])
def test_gmres_least_squares_on_card(device, rank):
  """The (21, 20) Hessenberg solve of a restart cycle, rank-deficient
  (columns past j zero) and full: finite, and the CPU's answer."""
  rng = np.random.default_rng(rank)
  H = np.zeros((21, 20), np.float32)
  for c in range(rank):
    H[:c + 2, c] = rng.standard_normal(c + 2)
  g = np.zeros(21, np.float32)
  g[0] = 2.0
  got = spl._lstsq_kernel(torch.from_numpy(H).to(device),
                          torch.from_numpy(g).to(device)).cpu().numpy()
  want = spl._lstsq_kernel(torch.from_numpy(H), torch.from_numpy(g)).numpy()
  assert np.isfinite(got).all()
  assert np.abs(got[rank:]).max(initial=0.0) == 0.0
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=1e-4 * np.abs(want).max())


# -- sp.sparse's builders, sp.linalg, sp.fft, sp.random and array files ----
# (the slice of ROADMAP Queue 1 items 4 and 7).  Tolerances: float64 dense
# factorizations against NumPy at 1e-10 of the result's largest entry
# (cuSOLVER and LAPACK sum in other orders; condition numbers below 1e3
# here); float32 FFTs at 1e-5 of the largest coefficient (log2 N · 2^-24
# with margin); float32 Lanczos within ``lanczos.lanczos_tol`` of a
# float64 run; draws at 6 standard errors of their first two moments.

from spartan_tpu_torch.examples import lanczos as LAN  # noqa: E402
from spartan_tpu_torch.examples import poisson as POISSON  # noqa: E402


def _grid_laplacian_on(nx, ny, dtype):
  d = [-1.0, 2.0, -1.0]
  return sp.sparse.kronsum(
      sp.sparse.diags(d, [-1, 0, 1], shape=(nx, nx), dtype=dtype),
      sp.sparse.diags(d, [-1, 0, 1], shape=(ny, ny), dtype=dtype))


def _close_on(got, want, tol):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape
  scale = max(float(np.abs(want).max()), 1e-300)
  assert float(np.abs(got - want).max()) <= tol * scale


def test_sparse_builders_on_card(device):
  import scipy.sparse as ss
  L = _grid_laplacian_on(64, 96, np.float32)
  assert L.cols.device == device and L.vals.dtype == torch.float32
  d = ss.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64))
  e = ss.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(96, 96))
  assert (L.to_scipy() != ss.kronsum(d, e).tocsr()).nnz == 0
  indptr, indices, data = L.to_csr()
  assert indptr.device == device and data.dtype == torch.float32
  R = sp.sparse.random(3000, 2000, density=0.01, random_state=4,
                       dtype=np.float32)
  cpu = sp.make_mesh("cpu")
  with sp.with_mesh(cpu):
    Rc = sp.sparse.random(3000, 2000, density=0.01, random_state=4,
                          dtype=np.float32)
  assert torch.equal(R.cols.cpu(), Rc.cols)
  assert torch.equal(R.vals.cpu(), Rc.vals)
  K = sp.sparse.kron(sp.sparse.eye(3), L)
  x = torch.randn(K.shape[1], device=device)
  y = sp.sparse.spmv(K, x)
  want = ss.kron(ss.eye(3), ss.kronsum(d, e)) @ x.cpu().double().numpy()
  _close_on(y.cpu().numpy(), want, 1e-5)


@pytest.mark.parametrize("nx, ny, kernel", [(64, 64, "ell"),
                                            (200, 200, "csr")])
def test_lanczos_launches_the_spmv_kernels_on_card(device, nx, ny, kernel):
  """float32 Lanczos of a grid Laplacian: one K3a (n = 4096) or K3b
  (n = 40000) launch a step, no plain run; within ``lanczos_tol`` of the
  float64 run (plain gathers) and at most the closed-form top k."""
  m, k = 24, 6
  L32 = _grid_laplacian_on(nx, ny, np.float32)
  KS.reset_counts()
  got = sp.linalg.eigvalsh_lanczos(L32, k=k, m=m)
  assert KS.counts[f"{kernel}_launches"] == m
  assert KS.counts["ell_plain_runs"] == KS.counts["csr_plain_runs"] == 0
  got64 = sp.linalg.eigvalsh_lanczos(_grid_laplacian_on(nx, ny, np.float64),
                                     k=k, m=m)
  slack = LAN.lanczos_tol(m, 8.0)
  assert np.abs(got - got64).max() <= slack
  lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  top = np.sort((lx[:, None] + ly[None, :]).ravel())[-k:]
  assert (got <= top + slack).all()


def test_sparse_norm_launches_k1_on_card(device):
  import scipy.sparse as ss
  M = ss.random(5000, 5000, density=0.002, random_state=np.random
                .RandomState(1), dtype=np.float32).tocsr()
  S = sps.from_scipy(M)
  K.reset_counts()
  got = float(sp.sparse.linalg.norm(S).glom())
  assert K.counts["launches"] == 1 and K.counts["plain_runs"] == 0
  np.testing.assert_allclose(got, ss.linalg.norm(M.astype(np.float64)),
                             rtol=1e-6)


def test_dense_linalg_on_card(device):
  rng = np.random.default_rng(3)
  n = 256
  m = rng.standard_normal((n, n))
  a = m @ m.T + n * np.eye(n)
  b = rng.standard_normal(n)
  A = sp.from_numpy(a)
  L = sp.linalg.cholesky(A, block=64)
  assert L.data.device == device
  _close_on(L.glom(), np.linalg.cholesky(a), 1e-10)
  _close_on(sp.linalg.solve(A, b, method="cholesky", block=64).glom(),
            np.linalg.solve(a, b), 1e-10)
  _close_on(sp.linalg.solve(A, b).glom(), np.linalg.solve(a, b), 1e-10)
  _close_on(sp.linalg.inv(A).glom(), np.linalg.inv(a), 1e-10)
  sign, logdet = sp.linalg.slogdet(A)
  assert float(sign.glom()) == 1.0
  np.testing.assert_allclose(float(logdet.glom()), np.linalg.slogdet(a)[1],
                             rtol=1e-12)
  w, v = sp.linalg.eigh(A)
  _close_on(w.glom(), np.linalg.eigvalsh(a), 1e-10)
  vn = v.glom()
  _close_on(a @ vn, vn * w.glom(), 1e-10)
  u, s, vt = sp.linalg.svd(sp.from_numpy(m))
  _close_on((u.glom() * s.glom()) @ vt.glom(), m, 1e-10)
  _close_on(s.glom(), np.linalg.svd(m, compute_uv=False), 1e-10)
  X = rng.standard_normal((4096, 16))
  Q, R = sp.linalg.qr(sp.from_numpy(X), method="tsqr")
  _close_on(Q.glom() @ R.glom(), X, 1e-12)
  y = rng.standard_normal(4096)
  _close_on(sp.linalg.lstsq(X, y).glom(),
            np.linalg.lstsq(X, y, rcond=None)[0], 1e-10)
  assert int(sp.linalg.matrix_rank(np.outer(b, b)).glom()) == 1


@pytest.mark.parametrize("name, fn", [("svd", "svd"), ("eigh", "eigh"),
                                      ("slogdet", "slogdet")])
def test_linalg_outputs_factor_once_on_card(device, monkeypatch, name, fn):
  """The outputs of one factorization, evaluated one by one on the card,
  factor the matrix once."""
  rng = np.random.default_rng(4)
  m = rng.standard_normal((128, 128))
  a = m @ m.T + 128 * np.eye(128)
  calls = []
  real = getattr(torch.linalg, fn)

  def counted(t, *args, **kw):
    if t.device.type == "cuda":
      calls.append(fn)
    return real(t, *args, **kw)

  monkeypatch.setattr(torch.linalg, fn, counted)
  outs = [o.evaluate() for o in getattr(sp.linalg, name)(sp.from_numpy(a))]
  assert calls == [fn] and all(o.data.device == device for o in outs)


def test_a_singular_matrix_does_not_raise_on_card(device):
  a = np.array([[1.0, 2.0], [2.0, 4.0]])
  got = sp.linalg.inv(a).glom()
  assert not np.isfinite(got).all()
  assert not np.isfinite(sp.linalg.solve(a, np.ones(2)).glom()).all()


def test_fft_on_card(device):
  rng = np.random.default_rng(4)
  x = rng.standard_normal((256, 384)).astype(np.float32)
  X = sp.from_numpy(x)
  F = sp.fft.fft2(X)
  assert F.dtype == torch.complex64
  _close_on(F.glom(), np.fft.fft2(x.astype(np.float64)), 1e-5)
  _close_on(sp.fft.rfft2(X).glom(), np.fft.rfft2(x.astype(np.float64)), 1e-5)
  _close_on(sp.fft.irfft2(sp.fft.rfft2(X), s=x.shape).glom(), x, 1e-5)
  z = x.astype(np.float64)
  import scipy.fft as sfft
  for t in (1, 2, 3, 4):
    _close_on(sp.fft.dct(z, type=t).glom(), sfft.dct(z, type=t), 1e-12)
    _close_on(sp.fft.idst(z, type=t, norm="ortho").glom(),
              sfft.idst(z, type=t, norm="ortho"), 1e-12)
  _close_on(sp.fft.hfftn(np.fft.rfftn(z), norm="ortho").glom(),
            sfft.hfftn(np.fft.rfftn(z), norm="ortho"), 1e-12)
  a = rng.standard_normal(64) * np.exp(-0.1 * np.arange(64))
  _close_on(sp.fft.fht(a, 0.05, 1.0, bias=0.1).glom(),
            sfft.fht(a, 0.05, 1.0, bias=0.1), 1e-11)


def test_poisson_spectral_solve_on_card(device):
  rng = np.random.default_rng(5)
  n = 512
  f = rng.standard_normal((n, n))
  f -= f.mean()
  u = POISSON.solve(sp.from_numpy(f))
  res = float(sp.max(sp.abs(POISSON.laplacian(u) - sp.from_numpy(f)))
              .glom())
  assert res <= 1e-12 * np.abs(f).max()
  k = 2.0 * np.pi * np.fft.fftfreq(n)
  lam = 2.0 * np.cos(k[:, None]) + 2.0 * np.cos(k[None, :]) - 4.0
  inv = np.where(lam == 0, 0.0, 1.0 / np.where(lam == 0, 1.0, lam))
  _close_on(u.glom(), np.real(np.fft.ifft2(np.fft.fft2(f) * inv)), 1e-12)


@pytest.mark.parametrize("op, params", [
    ("gamma", {"shape": 2.5, "scale": 1.5}), ("gamma", {"shape": 0.3}),
    ("beta", {"a": 0.5, "b": 2.0}), ("poisson", {"lam": 3.0}),
    ("binomial", {"n": 10, "p": 0.3}), ("exponential", {"scale": 2.0})])
def test_distributions_on_card(device, op, params):
  n = 1 << 20
  e = getattr(sp.random.default_rng(11), op)(*params.values(), size=n)
  t = e.evaluate().data
  assert t.device == device
  x = t.double().cpu().numpy()
  mean, var, mu4 = sp.random.moments(op, **params)
  assert abs(x.mean() - mean) < 6 * np.sqrt(var / n)
  assert abs(x.var() - var) < 6 * np.sqrt((mu4 - var * var) / n)


def test_files_on_card(device, tmp_path):
  x = torch.randn(300, 200, device=device)
  path = str(tmp_path / "a")
  sp.save(sp.Val(sp.SpartanArray(x)), path)
  back = sp.load(path)
  assert back.data.device == device and torch.equal(back.data, x)
  ck = sp.checkpoint(sp.Val(sp.SpartanArray(x)) * 2.0, str(tmp_path / "c"))
  got = float((ck + 1.0).sum().glom())
  np.testing.assert_allclose(got, float((x.double() * 2 + 1).sum()),
                             rtol=1e-6)
  again = sp.checkpoint(sp.zeros((300, 200), dtype=np.float32),
                        str(tmp_path / "c")).evaluate()
  assert torch.equal(again.data, x * 2.0)


# -- the spectral solvers and scipy_linalg on the card: eigsh, eigs, svds and
# expm_multiply with their steps' SpMVs on K3a/K3b (no plain run), the
# 0-based pivots of lu_factor, the matrix-function gate and its counts.
# Tolerances: float32 eigenvalues within 10 · 1e-5 of the spectral scale
# (eigsh's float32 residual tolerance, on a spectrum whose top gaps are
# wider than it); float64 factorizations 1e-10 of max|want|.

from spartan_tpu_torch import scipy_linalg as SL  # noqa: E402

SPECTRAL_F32 = 1e-5


def _grid_top(nx, ny, k):
  lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  return np.sort((lx[:, None] + ly[None, :]).ravel())[-k:]


@pytest.mark.parametrize("nx, ny, kernel", [(50, 70, "ell"),
                                            (180, 230, "csr")])
def test_eigsh_launches_the_spmv_kernels_on_card(device, nx, ny, kernel):
  """eigsh(L, k=3, 'LA') of a float32 rectangular grid's Laplacian: one
  K3a (n = 3500) or K3b (n = 41400) launch an Arnoldi step, fused restarts,
  no plain run; the Ritz values at the closed form's top 3 and at their
  vectors' Rayleigh quotients, the vectors' residuals in float64 small."""
  import scipy.sparse as ss
  L32 = _grid_laplacian_on(nx, ny, np.float32)
  KS.reset_counts()
  w, v = spl.eigsh(L32, k=3, which="LA", ncv=32, maxiter=80)
  st = dict(spl.stats)
  assert st["fused"] and v.data.device == device
  assert v.dtype == torch.float32
  assert KS.counts[f"{kernel}_launches"] == st["steps"] > 0
  assert KS.counts["ell_plain_runs"] == KS.counts["csr_plain_runs"] == 0
  top = _grid_top(nx, ny, 3)
  np.testing.assert_allclose(w, top, rtol=0,
                             atol=10 * SPECTRAL_F32 * top[-1])
  d = [-1.0, 2.0, -1.0]
  A = ss.kronsum(ss.diags(d, [-1, 0, 1], shape=(nx, nx)),
                 ss.diags(d, [-1, 0, 1], shape=(ny, ny))).tocsr()
  vv = v.glom().astype(np.float64)
  res = np.linalg.norm(A @ vv - vv * w, axis=0) / np.linalg.norm(vv, axis=0)
  assert res.max() <= 10 * SPECTRAL_F32 * top[-1]
  # the Ritz values are their vectors' Rayleigh quotients to float32
  # rounding (the restart's small eigh in float64: cuSOLVER's float32 one
  # let the basis lose its orthonormality)
  rho = (vv * (A @ vv)).sum(0) / (vv * vv).sum(0)
  assert np.abs(np.sort(w) - np.sort(rho)).max() <= 64 * 2.0 ** -24 * 8.0


def test_eigs_svds_expm_multiply_launch_the_kernels_on_card(device):
  """eigs on a float32 convection-diffusion operator (K3a a step), svds of
  a float32 sparse matrix with more than 32768 rows (A x on K3a, Aᵀ y on
  K3b), expm_multiply of a float32 Laplacian (K3b a step), each with no
  plain SpMV, against scipy in float64."""
  import scipy.linalg as sla
  import scipy.sparse as ss
  import scipy.sparse.linalg as ssl
  nx, ny = 40, 60
  d = [-1.0, 2.0, -1.0]
  Lg = ss.kronsum(ss.diags(d, [-1, 0, 1], shape=(nx, nx)),
                  ss.diags(d, [-1, 0, 1], shape=(ny, ny))).tocsr()
  C = (Lg + 0.3 * ss.kronsum(ss.diags([-1.0, 1.0], [-1, 0], shape=(nx, nx)),
                             ss.csr_matrix((ny, ny)))).tocsr()
  KS.reset_counts()
  w, v = spl.eigs(sps.from_scipy(C.astype(np.float32)), k=3, which="LM",
                  ncv=30, maxiter=80)
  assert KS.counts["ell_launches"] == spl.stats["steps"] > 0
  assert KS.counts["ell_plain_runs"] == 0
  ww = ssl.eigs(C, k=3, which="LM")[0]
  scale = np.abs(ww).max()
  np.testing.assert_allclose(np.sort(np.abs(w)), np.sort(np.abs(ww)),
                             atol=10 * SPECTRAL_F32 * scale)
  R = ss.random(40000, 3000, density=4e-3,
                random_state=np.random.RandomState(5), format="csr")
  S = sps.from_scipy(R.astype(np.float32))
  KS.reset_counts()
  u, s, vt = spl.svds(S, k=4)
  steps = spl.stats["steps"]
  assert KS.counts["ell_launches"] == steps + 4  # A x, and A v for u
  assert KS.counts["csr_launches"] == steps      # Aᵀ y
  assert KS.counts["ell_plain_runs"] == KS.counts["csr_plain_runs"] == 0
  sw = np.sort(ssl.svds(R, k=4, return_singular_vectors=False))
  np.testing.assert_allclose(s, sw, atol=10 * SPECTRAL_F32 * sw[-1])
  big = _grid_laplacian_on(190, 200, np.float32)   # n = 38000: K3b
  x = np.random.default_rng(6).standard_normal(38000).astype(np.float32)
  KS.reset_counts()
  y = spl.expm_multiply(big * -1.0, x, t=0.5, ncv=20)
  assert KS.counts["csr_launches"] == 20 and KS.counts["csr_plain_runs"] == 0
  Lb = ss.kronsum(ss.diags(d, [-1, 0, 1], shape=(190, 190)),
                  ss.diags(d, [-1, 0, 1], shape=(200, 200))).tocsc()
  want = ssl.expm_multiply(-0.5 * Lb, x.astype(np.float64))
  _close_on(y.glom(), want, 1e-5)
  del sla


def test_lu_factor_pivots_and_solves_on_card(device):
  """lu_factor on the card returns scipy's 0-based pivots (cuSOLVER's are
  1-based), and lu_solve/cho_solve solve with them."""
  import scipy.linalg as sla
  rng = np.random.default_rng(12)
  a = rng.standard_normal((300, 300))
  b = rng.standard_normal((300, 2))
  lu_, piv = SL.lu_factor(a)
  pv = piv.evaluate()
  assert pv.data.device == device
  wlu, wpiv = sla.lu_factor(a)
  np.testing.assert_array_equal(pv.glom(), wpiv)
  _close_on(lu_.glom(), wlu, 1e-10)
  _close_on(SL.lu_solve((lu_, piv), b).glom(), np.linalg.solve(a, b), 1e-10)
  _close_on(SL.lu_solve((lu_, piv), b, trans=1).glom(),
            np.linalg.solve(a.T, b), 1e-10)
  spd = a @ a.T + 300 * np.eye(300)
  c = SL.cho_factor(spd)
  _close_on(SL.cho_solve(c, b).glom(), np.linalg.solve(spd, b), 1e-10)
  _close_on(SL.expm(0.01 * a).glom(), sla.expm(0.01 * a), 1e-10)


def test_matrix_function_gate_on_card(device):
  """sqrtm/logm/signm of an SPD matrix come from the card's iteration
  (counted in ``matfun_device``); a matrix with negative eigenvalues fails
  the gate and takes scipy's host path, counted in
  ``matfun_host_fallbacks``; a complex input goes to the host, counted in
  ``matfun_complex_host``."""
  import scipy.linalg as sla
  rng = np.random.default_rng(13)
  m = rng.standard_normal((64, 64))
  spd = m @ m.T + 64 * np.eye(64)
  SL.reset_counts()
  X = SL.sqrtm(spd)
  _close_on(X.glom(), sla.sqrtm(spd), 1e-10)
  _close_on(SL.logm(spd).glom(), sla.logm(spd), 1e-10)
  _close_on(SL.signm(spd - 80 * np.eye(64)).glom(),
            sla.signm(spd - 80 * np.eye(64)), 1e-8)
  assert SL.counts == {"matfun_device": 3, "matfun_host_fallbacks": 0,
                       "matfun_complex_host": 0}
  N = m @ np.diag(np.concatenate([[-2.0, -0.5], 3 + np.arange(62.)])) \
      @ np.linalg.inv(m)
  got = SL.sqrtm(N).glom()
  assert np.iscomplexobj(got)
  _close_on(got, sla.sqrtm(N), 1e-8)
  SL.sqrtm(N.astype(complex)).glom()
  assert SL.counts == {"matfun_device": 3, "matfun_host_fallbacks": 1,
                       "matfun_complex_host": 1}


# -- autodiff and sp.sparse.csgraph on the card --------------------------------
# Tolerances: float32 terms summed in float64 by K1 against NumPy's float64
# at rtol 1e-6 (each term rounds once, 6e-8); the sum's gradient at rtol
# 1e-6 (exact signs times 2); float64 graphs at
# 1e-12 (the same path sums); the SpMV gradient at 1e-5 of max|g|.


def test_grad_through_a_float32_sum_takes_the_plain_path_on_card(device):
  """sp.grad of a float32 full sum is right and launches nothing: the
  differentiable emit skips K1, whose wrapper refuses a tensor that
  requires grad."""
  b_np = np.random.default_rng(30).standard_normal((512, 384)).astype(
      np.float32)
  b = sp.from_numpy(b_np)
  K.reset_counts()
  v, (g,) = sp.value_and_grad(sp.sum(sp.abs(1 + 2 * b)), [b])
  assert K.counts["launches"] == 0
  np.testing.assert_allclose(float(v.glom()),
                             np.abs(1 + 2 * b_np.astype(np.float64)).sum(),
                             rtol=1e-6)
  np.testing.assert_allclose(g.glom(), 2 * np.sign(1 + 2 * b_np), rtol=1e-6)
  x = torch.randn(1000, device=device, requires_grad=True)
  with pytest.raises(RuntimeError, match="fused_reduce.fused_sum"):
    K.fused_sum(x, K.plan(None, 0, torch.float32, {}))


def test_compile_launches_k1_on_card(device):
  """sp.compile emits without autograd: one K1 launch a call."""
  rng = np.random.default_rng(31)
  b = sp.from_numpy(rng.standard_normal((1024, 1024)).astype(np.float32))
  f = sp.compile(sp.sum(sp.abs(1 + 2 * b)), wrt=[b])
  K.reset_counts()
  for _ in range(3):
    fresh = rng.standard_normal((1024, 1024)).astype(np.float32)
    np.testing.assert_allclose(
        float(f(fresh).glom()), np.abs(1 + 2 * fresh.astype(np.float64)).sum(),
        rtol=1e-6)
  assert K.counts["launches"] == 3 and K.counts["plain_runs"] == 0


def test_spmv_grad_and_compiled_step_on_card(device):
  """grad through the CSR kernel's route (its plain version) against
  A.T c, and a compiled SpMV step launching K3b once a call."""
  import scipy.sparse as ss
  A = ss.random(40000, 40000, density=2e-4, random_state=32, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  rng = np.random.default_rng(33)
  x = sp.from_numpy(rng.standard_normal(40000).astype(np.float32))
  c = rng.standard_normal(40000).astype(np.float32)
  KS.reset_counts()
  (g,) = sp.grad(sp.sum(sps.spmv_expr(S, x) * sp.from_numpy(c)), [x])
  assert KS.counts["csr_launches"] == KS.counts["csr_plain_runs"] == 0
  want = A.T.astype(np.float64) @ c
  # float32 products summed over about 8 entries a column in another order
  assert np.abs(g.glom() - want).max() <= 1e-5 * np.abs(want).max()
  f = sp.compile(sps.spmv_expr(S, x) * 0.5, wrt=[x])
  KS.reset_counts()
  for _ in range(2):
    f(rng.standard_normal(40000).astype(np.float32))
  assert KS.counts["csr_launches"] == 2


def test_csgraph_on_card(device):
  """dijkstra, weak components and Floyd-Warshall on the card against
  scipy."""
  import scipy.sparse as ss
  import scipy.sparse.csgraph as cs
  rng = np.random.default_rng(34)
  W = rng.uniform(0.1, 5.0, (300, 300)) * (rng.random((300, 300)) < 0.02)
  np.fill_diagonal(W, 0)
  C = sp.sparse.csgraph
  np.testing.assert_allclose(C.dijkstra(W, indices=[0, 7]),
                             cs.dijkstra(ss.csr_matrix(W), indices=[0, 7]),
                             rtol=1e-12)
  nc, _ = C.connected_components(W, directed=True, connection="weak")
  assert nc == cs.connected_components(ss.csr_matrix(W), directed=True,
                                       connection="weak")[0]
  np.testing.assert_allclose(C.floyd_warshall(W[:64, :64]),
                             cs.floyd_warshall(ss.csr_matrix(W[:64, :64])),
                             rtol=1e-12)


# -- sp.optimize and sp.integrate on the card --------------------------------

def _kept_on_card(seen, runs):
  from spartan_tpu_torch.expr import fio
  assert seen == {"cuda"}, seen
  assert fio.counts["host_runs"] == runs  # no host route was taken


def test_least_squares_on_card(device):
  """The reference test's decay fit at 4096 samples: every residual and
  Jacobian pass on cuda tensors, no host route, against scipy at 1e-8."""
  import scipy.optimize as so
  from spartan_tpu_torch.expr import fio
  rng = np.random.default_rng(41)
  t_host = np.linspace(0, 3, 4096)
  y_host = 2.5 * np.exp(-1.3 * t_host) + 0.4 + 1e-3 * rng.normal(size=4096)
  t, y = (torch.as_tensor(v, device=device) for v in (t_host, y_host))
  seen, runs = set(), fio.counts["host_runs"]

  def resid(p):
    seen.add(p.device.type)
    return p[0] * torch.exp(-p[1] * t) + p[2] - y

  got = sp.optimize.least_squares(resid, np.ones(3))
  bounded = sp.optimize.least_squares(resid, np.ones(3),
                                      bounds=([0, 0, 0], [5, 1.25, 1]))
  _kept_on_card(seen, runs)
  tight = {"xtol": 1e-14, "ftol": 1e-14, "gtol": 1e-14}
  want = so.least_squares(lambda p: p[0] * np.exp(-p[1] * t_host) + p[2]
                          - y_host, np.ones(3), method="lm", **tight).x
  want_b = so.least_squares(lambda p: p[0] * np.exp(-p[1] * t_host) + p[2]
                            - y_host, np.ones(3), bounds=([0, 0, 0],
                                                          [5, 1.25, 1]),
                            **tight).x
  assert got.success and np.abs(got.x - want).max() < 1e-8
  assert bounded.success and np.abs(bounded.x - want_b).max() < 1e-8


def test_solve_ivp_on_card(device):
  """RK45 of a 1024-unknown heat equation from a sine mode, every stage on
  cuda tensors, against exp(-lambda t) y0 within steps (atol + rtol)."""
  from spartan_tpu_torch.expr import fio
  n, k = 1024, 300
  h = 1.0 / (n + 1)
  x = torch.arange(1, n + 1, dtype=torch.float64, device=device) * h
  lam = 4.0 / h ** 2 * np.sin(k * np.pi * h / 2.0) ** 2
  y0 = torch.sin(k * np.pi * x)
  seen, runs = set(), fio.counts["host_runs"]

  def heat(t, y):
    seen.add(y.device.type)
    seen.add(t.device.type)
    out = -2.0 * y
    out[1:] += y[:-1]
    out[:-1] += y[1:]
    return out / h ** 2

  te = np.linspace(0.0, 5.0 / lam, 4)
  res = sp.integrate.solve_ivp(heat, (0.0, 5.0 / lam), y0, t_eval=te,
                               rtol=1e-10, atol=1e-20)
  _kept_on_card(seen, runs)
  want = np.exp(-lam * te)[None, :] * y0.cpu().numpy()[:, None]
  rms = np.sqrt(np.mean((res.y - want) ** 2, axis=0)).max()
  assert res.success and rms <= (res.nfev // 7) * 1e-10


def test_differential_evolution_on_card(device):
  """Its population is drawn by a generator on the card and evaluated by
  vmap there: the 4-D Rastrigin function to its global minimum."""
  from spartan_tpu_torch.expr import fio
  seen, runs = set(), fio.counts["host_runs"]

  def rastrigin(p):
    seen.add(p.device.type)
    return 10.0 * p.shape[-1] + torch.sum(p * p - 10.0 * torch.cos(
        2.0 * np.pi * p))

  res = sp.optimize.differential_evolution(
      rastrigin, [(-5.12, 5.12)] * 4, seed=5, tol=1e-8, popsize=20,
      recombination=0.2)
  _kept_on_card(seen, runs)
  assert res.fun <= 1e-8 and np.abs(res.x).max() <= 1e-5


# -- learn's estimators, the examples and sp.special on the card --------------
# ALS on a SparseArray takes K5a; sp.special's betainc (a
# converging continued fraction) and gammaincinv (90 fixed halvings a side)
# against scipy at the CPU test's bounds; netflix SGD's two routes within
# 16 ulps of a row's absolute sum (the scatter route adds with atomics).


def test_learn_als_on_a_sparse_array_launches_k5a_on_card(device):
  import scipy.sparse as ss

  from spartan_tpu_torch import learn
  from spartan_tpu_torch.examples import als as ALS
  A = ss.random(3000, 2000, density=0.01, random_state=7, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  # ALS's factors are float64: no densified route, the CSR kernel
  assert sps._spmm_route(S, torch.float64, 8, on_accel=True)[0] == "winmm"
  K5.reset_counts()
  est = learn.ALS(n_factors=8, iterations=2, reg=0.1, seed=0).fit(S)
  assert K5.counts["launches"] == 4 and K5.counts["plain_runs"] == 0
  U, V = ALS.fit(S, k=8, iterations=2, reg=0.1, seed=0)
  np.testing.assert_allclose(est.user_factors_, U, rtol=0,
                             atol=1e-6 * np.abs(U).max())
  np.testing.assert_allclose(est.item_factors_, V, rtol=0,
                             atol=1e-6 * np.abs(V).max())


def test_special_betainc_and_gammaincinv_on_card(device):
  import scipy.special as ssp
  rng = np.random.default_rng(22)
  a, b = rng.uniform(0.5, 8.0, 4096), rng.uniform(0.5, 8.0, 4096)
  x = rng.uniform(0.01, 0.99, 4096)
  got = sp.special.betainc(sp.from_numpy(a), sp.from_numpy(b),
                           sp.from_numpy(x)).evaluate()
  assert got.data.device.type == "cuda"
  np.testing.assert_allclose(got.glom(), ssp.betainc(a, b, x), rtol=1e-12,
                             atol=1e-13)
  y = np.array([1e-290, 1e-150, 1e-12, 1e-8, 0.3, 0.5, 0.7, 1 - 1e-8,
                1 - 1e-12])
  for s in (0.5, 2.5, 8.0):
    # the reference test's bounds (an underflowed root is the bracket's
    # floor, exp(-708), within its atol of scipy's 0)
    np.testing.assert_allclose(sp.special.gammaincinv(s, y).glom(),
                               ssp.gammaincinv(s, y), rtol=1e-11,
                               atol=1e-13)
  x32 = sp.from_numpy(x.astype(np.float32))
  got32 = sp.special.betainc(2.0, 3.5, x32).glom()
  assert got32.dtype == np.float32
  np.testing.assert_allclose(got32, ssp.betainc(2.0, 3.5, x.astype(
      np.float32).astype(np.float64)), rtol=2e-4, atol=2e-5)


def test_netflix_step_routes_agree_on_card(device):
  from spartan_tpu_torch.examples import netflix_sgd as nf
  rng = np.random.default_rng(5)
  nu, ni, k, B = 5000, 800, 16, 2048
  U, V = rng.standard_normal((nu, k)), rng.standard_normal((ni, k))
  users, items = rng.integers(0, nu, B), rng.integers(0, ni, B)
  ratings = rng.uniform(0.5, 5.0, B)
  args = [sp.from_numpy(v) for v in (U, V, users, items, ratings)]
  a = sp.evaluate(sp.ListExpr(list(nf.sgd_step(*args, use_matmul=True))))
  b = sp.evaluate(sp.ListExpr(list(nf.sgd_step(*args, use_matmul=False))))
  e = ((U[users] * V[items]).sum(1) - ratings)[:, None]
  for got, want, base, idx, g in (
      (a[0], b[0], U, users, e * V[items] + 0.02 * U[users]),
      (a[1], b[1], V, items, e * U[users] + 0.02 * V[items])):
    mass = np.abs(base).copy()
    np.add.at(mass, idx, np.abs(0.05 * g))
    assert np.abs(got.glom() - want.glom()).max() <= (
        16 * 2.0 ** -53 * mass).max()


def test_examples_cli_on_card(device, capsys):
  from spartan_tpu_torch.examples.__main__ import main
  assert main(["knn"]) == 0
  printed = capsys.readouterr().out.strip().splitlines()[-1]
  assert "'accuracy': 1.0" in printed and "'example': 'knn'" in printed


# -- sp.stats and sp.signal on the card ---------------------------------------

def test_lfilter_of_a_float64_batch_on_card(device):
  """lfilter's loop over the samples on cuda tensors (three launches a
  sample, no host read), batched along axis 0 and -1, and filtfilt and
  sosfiltfilt, against scipy at the reference test's bounds."""
  import scipy.signal as ssig
  rng = np.random.default_rng(23)
  X = rng.standard_normal((64, 2000))
  b, a = ssig.butter(4, 0.1)
  got = sp.signal.lfilter(b, a, X, axis=-1).evaluate()
  assert got.data.device.type == "cuda"
  np.testing.assert_allclose(got.glom(), ssig.lfilter(b, a, X, axis=-1),
                             atol=1e-10)
  np.testing.assert_allclose(
      sp.signal.lfilter(b, a, X.T, axis=0).glom(),
      ssig.lfilter(b, a, X.T, axis=0), atol=1e-10)
  np.testing.assert_allclose(sp.signal.filtfilt(b, a, X).glom(),
                             ssig.filtfilt(b, a, X), atol=1e-9)
  sos = ssig.butter(8, 0.1, output="sos")
  np.testing.assert_allclose(sp.signal.sosfiltfilt(sos, X[:, :500]).glom(),
                             ssig.sosfiltfilt(sos, X[:, :500]), atol=1e-7)
  zi = ssig.lfilter_zi(b, a) * X[0, 0]
  y, zf = sp.signal.lfilter(b, a, X[0], zi=zi)
  want_y, want_zf = ssig.lfilter(b, a, X[0], zi=zi)
  np.testing.assert_allclose(y.glom(), want_y, atol=1e-10)
  np.testing.assert_allclose(zf.glom(), want_zf, atol=1e-10)


def test_stats_inverses_and_normal_tail_on_card(device):
  """t.ppf and binom.cdf through betainc's continued fraction on the card,
  the normal CDF's left tail (F3: torch.special.ndtr is 2.5e-8 off at -6
  and 0 below -8.3 on the card too) and a test's p-value, against scipy."""
  import scipy.stats as sst
  rng = np.random.default_rng(24)
  q = rng.uniform(0.001, 0.999, 4096)
  got = sp.stats.t.ppf(sp.from_numpy(q), 5.0, 0.3, 1.5).evaluate()
  assert got.data.device.type == "cuda"
  np.testing.assert_allclose(got.glom(), sst.t.ppf(q, 5.0, 0.3, 1.5),
                             rtol=1e-9, atol=1e-10)
  k = rng.integers(0, 13, 4096).astype(np.float64)
  np.testing.assert_allclose(sp.stats.binom.cdf(k, 12, 0.3).glom(),
                             sst.binom.cdf(k, 12, 0.3), rtol=1e-10,
                             atol=1e-12)
  z = np.linspace(-37.0, -0.5, 500)
  np.testing.assert_allclose(sp.stats.norm.cdf(z).glom(), sst.norm.cdf(z),
                             rtol=1e-13, atol=0)
  x, y = rng.standard_normal(5000), rng.standard_normal(5000) + 0.05
  res, want = sp.stats.ttest_ind(x, y), sst.ttest_ind(x, y)
  np.testing.assert_allclose([float(res.statistic), float(res.pvalue)],
                             [want.statistic, want.pvalue], rtol=1e-10)
  r = sp.stats.rankdata(np.round(x * 3)).glom()
  np.testing.assert_array_equal(r, sst.rankdata(np.round(x * 3)))


def test_medfilt_with_sign_bit_nans_on_card(device):
  """medfilt sorts its stack of shifted copies through sort_expr, which
  makes every NaN the one quiet NaN first: a NaN with its sign bit set
  sorts last, as NumPy's, not first as the card's radix sort would put
  it.  Held to the port's CPU result bit for bit and, away from the NaNs,
  to scipy."""
  import scipy.signal as ssig
  rng = np.random.default_rng(25)
  x = rng.standard_normal(4096)
  x[[100, 2000]] = -np.nan
  x[3000] = np.nan
  assert np.signbit(x[100])
  got = sp.signal.medfilt(x, 5).glom()
  sp.initialize(["--device=cpu"])
  try:
    want = sp.signal.medfilt(x, 5).glom()
  finally:
    sp.initialize(["--device=cuda"])
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
  # away from the NaNs, scipy's median of the same windows (its own filter
  # is given zeros for the NaNs: a window that holds none does not see them)
  clean = np.ones(4096, bool)
  for i in (100, 2000, 3000):
    clean[i - 2:i + 3] = False
  np.testing.assert_array_equal(
      got[clean], ssig.medfilt(np.nan_to_num(x, nan=0.0), 5)[clean])


def test_oscillator_on_card(device):
  from spartan_tpu_torch.examples import oscillator
  got, want = oscillator.run()
  assert got == 0.299853515625
  assert abs(got - want) < (2048 - 1) / 40.0 / 512


def test_ndimage_on_card(device):
  """sp.ndimage on cuda tensors: the conv filters (cuDNN, TF32 off), the
  rank filters' sorted stacks, the loops and label against scipy, and the
  order-1 gather; float64 at the CPU test's bounds."""
  import scipy.ndimage as ndi
  rng = np.random.default_rng(26)
  A = rng.standard_normal((300, 257))
  w = rng.standard_normal((3, 4))
  got = sp.ndimage.correlate(A, w, mode="mirror", origin=(0, 1)).evaluate()
  assert got.data.device.type == "cuda"
  np.testing.assert_allclose(got.glom(), ndi.correlate(
      A, w, mode="mirror", origin=(0, 1)), rtol=1e-10, atol=1e-12)
  np.testing.assert_allclose(sp.ndimage.gaussian_filter(A, 2.5).glom(),
                             ndi.gaussian_filter(A, 2.5), atol=1e-12)
  np.testing.assert_array_equal(sp.ndimage.median_filter(A, 4).glom(),
                                ndi.median_filter(A, 4))
  B = ndi.gaussian_filter(rng.standard_normal((300, 257)), 3) > 0.05
  np.testing.assert_array_equal(sp.ndimage.binary_fill_holes(B).glom(),
                                ndi.binary_fill_holes(B))
  got, n = sp.ndimage.label(B)
  want, m = ndi.label(B)
  assert n == m
  np.testing.assert_array_equal(got, want)
  np.testing.assert_allclose(sp.ndimage.rotate(A, 30.0, order=1).glom(),
                             ndi.rotate(A, 30.0, order=1), atol=1e-10)


def test_measurement_segment_reductions_on_card(device):
  """The per-label measurements by index_add_/scatter_reduce on the card
  (atomics: the float64 sums' order varies) against a float64 host oracle
  (np.add.at, np.minimum.at): sums and means within 1e-13 relative of
  each label's absolute sum, extrema and their first positions exact."""
  import scipy.ndimage as ndi
  rng = np.random.default_rng(27)
  lab, n = ndi.label(ndi.gaussian_filter(rng.standard_normal((512, 512)),
                                         2) > 0.1)
  x = rng.standard_normal((512, 512))
  idx = np.arange(1, n + 1)
  sums = np.zeros(n + 1)
  np.add.at(sums, lab.ravel(), x.ravel())
  abs_sums = np.zeros(n + 1)
  np.add.at(abs_sums, lab.ravel(), np.abs(x.ravel()))
  got = sp.ndimage.sum_labels(x, sp.from_numpy(lab), idx)
  assert np.all(np.abs(got - sums[1:]) <= 1e-13 * abs_sums[1:])
  mins = np.full(n + 1, np.inf)
  np.minimum.at(mins, lab.ravel(), x.ravel())
  np.testing.assert_array_equal(sp.ndimage.minimum(x, lab, idx), mins[1:])
  assert sp.ndimage.maximum_position(x, lab, idx) == \
      ndi.maximum_position(x, lab, idx)
  np.testing.assert_allclose(sp.ndimage.center_of_mass(x * x, lab, idx),
                             ndi.center_of_mass(x * x, lab, idx), rtol=1e-12)


def test_kdtree_query_ties_on_card(device):
  """torch.topk on CUDA promises no order among equal values: the query's
  stable rule gives the lower index first among equal distances on the
  card too, the CPU's indices, on a lattice with duplicate points."""
  lat = np.stack(np.meshgrid(np.arange(40.0), np.arange(40.0),
                             indexing="ij"), -1).reshape(-1, 2)
  lat = np.concatenate([lat, lat[:200], lat[500:700]])
  q = np.concatenate([lat[:300] + 0.5, lat[:100]])
  d, i = sp.spatial.KDTree(lat).query(q, k=9)
  got_d, got_i = d.glom(), i.glom()
  sp.initialize(["--device=cpu"])
  try:
    d0, i0 = sp.spatial.KDTree(lat).query(q, k=9)
    want_d, want_i = d0.glom(), i0.glom()
  finally:
    sp.initialize(["--device=cuda"])
  np.testing.assert_array_equal(got_i, want_i)
  np.testing.assert_allclose(got_d, want_d, rtol=1e-15)


def test_spatial_distance_and_rotation_on_card(device):
  """cdist through the matmul form and the chunked broadcast (a budget
  small enough to cut a's rows) and Rotation's conversions on the card."""
  import scipy.spatial.distance as ssd
  from scipy.spatial.transform import Rotation as SR

  from spartan_tpu_torch import spatial_distance as dist_mod
  rng = np.random.default_rng(28)
  a, b = rng.standard_normal((300, 16)), rng.standard_normal((200, 16))
  np.testing.assert_allclose(sp.spatial.distance.cdist(a, b).glom(),
                             ssd.cdist(a, b), rtol=1e-10, atol=1e-12)
  saved = dist_mod.BUDGET
  dist_mod.BUDGET = 32 * 200 * 16 * 8
  try:
    for m in ("cityblock", "chebyshev", "braycurtis"):
      np.testing.assert_allclose(sp.spatial.distance.cdist(a, b, m).glom(),
                                 ssd.cdist(a, b, m), rtol=1e-12)
  finally:
    dist_mod.BUDGET = saved
  q = rng.standard_normal((1000, 4))
  r = sp.spatial.transform.Rotation.from_quat(q)
  np.testing.assert_allclose(r.as_matrix().glom(),
                             SR.from_quat(q).as_matrix(), atol=1e-14)
  np.testing.assert_allclose(r.as_euler("zyx").glom(),
                             SR.from_quat(q).as_euler("zyx"), atol=1e-10)
  v = rng.standard_normal((1000, 3))
  np.testing.assert_allclose(r.apply(v).glom(), SR.from_quat(q).apply(v),
                             atol=1e-13)
  np.testing.assert_allclose(r.mean().as_matrix().glom(),
                             SR.from_quat(q).mean().as_matrix(), atol=1e-12)
