"""K2's plain version (``matmul_plain``) against the reference's Pallas
``matmul.matmul(..., interpret=True)``, and the epilogue's translation into
K1's op program (``matmul.plan_epilogue``) checked by evaluating the
program with torch.

Tolerance: the two sides sum the same K exact products in float32 in
another order (the reference per K block, the port in one torch matmul),
so they differ by d <= 2·K·2^-24·(|x| @ |y|); a bfloat16 output rounds each
side once more, 2u·(|ref| + d) on top (u = 2^-8).  The translated programs
run the epilogue's own torch ops in its order, so they agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_tpu.backend.kernels import matmul as ref_matmul

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.backend.kernels import matmul as K2


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _relu(acc):
  return torch.clamp_min(acc, 0.0)


def _inputs(m, k, n, seed):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal((m, k)).astype(np.float32),
          rng.standard_normal((k, n)).astype(np.float32))


def _close(got, want, x, y, unit):
  got = got.float().numpy().astype(np.float64)
  want = np.asarray(want, np.float64)
  d = 2.0 * x.shape[1] * 2.0 ** -24 * (np.abs(x.astype(np.float64))
                                      @ np.abs(y.astype(np.float64)))
  tol = d + 2.0 * unit * (np.abs(want) + d)
  assert got.shape == want.shape
  assert bool((np.abs(got - want) <= tol).all())


# (m, k, n, bm, bn, bk): the reference test's two shapes and a shape off
# the (8, 128) grid, where the reference takes full-dimension blocks
SHAPES = [(64, 256, 128, 32, 128, 128), (32, 128, 128, 32, 128, 128),
          (17, 40, 72, 512, 512, 512)]


@pytest.mark.parametrize("relu", [False, True], ids=["none", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matmul_plain_matches_reference_kernel(shape, dtype, relu):
  m, k, n, bm, bn, bk = shape
  a, b = _inputs(m, k, n, m + k + n)
  jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "float32" else torch.bfloat16
  ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
  want = ref_matmul.matmul(
      ja, jb, bm=bm, bn=bn, bk=bk,
      epilogue=(lambda acc: jnp.maximum(acc, 0.0)) if relu else None,
      interpret=True)
  assert want.dtype == jdt
  ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
  before = dict(K2.counts)
  got = K2.matmul(ta, tb, bm=bm, bn=bn, bk=bk,
                  epilogue=_relu if relu else None)
  assert K2.counts == dict(before, plain_runs=before["plain_runs"] + 1)
  assert got.dtype == tdt
  _close(got, np.asarray(want.astype(jnp.float32)),
         ta.float().numpy(), tb.float().numpy(),
         0.0 if dtype == "float32" else 2.0 ** -8)


EPILOGUES = {
    "clamp_min": lambda a: torch.clamp_min(a, 0.0),
    "F.relu": lambda a: torch.nn.functional.relu(a),
    "torch.relu": lambda a: torch.relu(a),
    "method relu": lambda a: a.relu(),
    "affine": lambda a: 1.0 - 2 * a,
    "bias then scale": lambda a: (a + 0.5) / 3.0,
    "abs plus": lambda a: abs(a) + 3,
    "gaussian": lambda a: torch.exp(-a * a),
    "leaky": lambda a: torch.maximum(a, a * 0.1),
    "clamps": lambda a: a.clamp_min(-1.0).clamp_max(1.0),
    "sqrt log": lambda a: torch.log(torch.sqrt(torch.square(a) + 1.0)),
    "identity": lambda a: a,
}


@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_epilogue_translates_into_the_op_program(name):
  epilogue = EPILOGUES[name]
  program = K2.plan_epilogue(epilogue)
  assert program is not None
  assert program.dtype == torch.float32 and not program.dev_scalars
  acc = torch.from_numpy(
      np.random.default_rng(3).standard_normal((9, 13)).astype(np.float32))
  got = K.evaluate_program(program, acc, [])
  assert got.dtype == torch.float32
  assert torch.equal(got, epilogue(acc))


OUTSIDE = {
    "sigmoid": torch.sigmoid,
    "power": lambda a: torch.float_power(a, 2),  # ** itself is in the table
    "to float64": lambda a: a.double(),
    "clamp with keywords": lambda a: torch.clamp(a, min=0.0),
    "tensor operand": lambda a: a + torch.ones(13),
    "data-dependent branch": lambda a: a if a.sum() > 0 else -a,
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_epilogue_outside_the_table_is_not_translated(name):
  assert K2.plan_epilogue(OUTSIDE[name]) is None


SCALE = 2.0


def test_epilogue_plan_follows_a_changed_global():
  """fx bakes a global number into the program as an immediate, so the plan
  of one function must follow the global's current value."""
  global SCALE
  epilogue = lambda a: a * SCALE  # noqa: E731
  acc = torch.arange(-3.0, 4.0)
  try:
    for value in (2.0, -0.5, 3):
      SCALE = value
      program = K2.plan_epilogue(epilogue)
      assert program is not None
      assert torch.equal(K.evaluate_program(program, acc, []), acc * value)
  finally:
    SCALE = 2.0


def test_matmul_wrapper_checks_shapes_and_runs_plain_on_cpu():
  a, b = _inputs(5, 6, 7, 1)
  ta, tb = torch.from_numpy(a), torch.from_numpy(b)
  with pytest.raises(ValueError, match="x \\(M, K\\) and y \\(K, N\\)"):
    K2.matmul(ta, tb.t())
  got = K2.matmul(ta.double(), tb.double(), epilogue=torch.tanh)
  assert got.dtype == torch.float64
  want = torch.tanh(ta @ tb).double()
  torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- operands TMA cannot describe ------------------------------------------------
# The 16-bit kernel reads its operands through TMA, which needs a 16-byte
# aligned base and a row stride of a multiple of 16 bytes.  Others are
# copied into a zero-padded, aligned buffer, which the kernel reads with the
# operand's own extents.  Exact: the kernel's view of a padded buffer is
# the operand itself, and in float64 (where these bfloat16 products and
# their sums are exact) the zero-padded product equals the unpadded one.

PAD_SIZES = [1, 7, 9, 1001]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tma_unfit_predicate(dtype):
  for cols, unfit in ((1, True), (7, True), (8, False), (9, True),
                      (1001, True), (1024, False)):
    t = torch.zeros((3, cols), dtype=dtype)
    assert K2.tma_unfit(t) == unfit, cols
  flat = torch.zeros(3 * 64 + 8, dtype=dtype)
  assert not K2.tma_unfit(flat[:3 * 64].view(3, 64))
  assert K2.tma_unfit(flat[1:1 + 3 * 64].view(3, 64))  # 2 bytes off
  assert not K2.tma_unfit(flat[8:8 + 3 * 64].view(3, 64))


def _padded_case(k, n, seed, misaligned=False):
  rng = np.random.default_rng(seed)
  x = torch.from_numpy(rng.standard_normal((5, k)).astype(
      np.float32)).bfloat16()
  y = torch.from_numpy(rng.standard_normal((k, n)).astype(
      np.float32)).bfloat16()
  if misaligned:  # the same values at a base 2 bytes past an aligned one
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    x = flat[1:].view(x.shape)
  return x, y


@pytest.mark.parametrize("n", PAD_SIZES)
@pytest.mark.parametrize("k", PAD_SIZES + ["misaligned"])
def test_padded_operands_give_the_unpadded_product(k, n):
  misaligned = k == "misaligned"
  x, y = _padded_case(64 if misaligned else k, n, 7 + n, misaligned)
  k = x.shape[1]
  assert K2.tma_unfit(x) and K2.tma_unfit(y) == (n % 8 != 0)
  xp, yp = K2.pad_operand(x), K2.pad_operand(y)
  for t, p in ((x, xp), (y, yp)):
    assert not K2.tma_unfit(p) and p.shape[0] == t.shape[0]
    assert p.shape[1] % 8 == 0 and p.shape[1] - t.shape[1] < 8
    assert torch.equal(p[:, :t.shape[1]], t)
    assert not p[:, t.shape[1]:].any()
  # what the kernel reads: the padded buffers with the operands' extents
  assert torch.equal(K2.matmul_plain(xp[:, :k], yp[:, :n]),
                     K2.matmul_plain(x, y))
  # zeros add exact zeros: the whole zero-padded product, in float64
  ypk = torch.zeros((xp.shape[1], yp.shape[1]), dtype=y.dtype)
  ypk[:k] = yp
  full = xp.double() @ ypk.double()
  assert torch.equal(full[:, :n], x.double() @ y.double())
  assert not full[:, n:].any()


# -- the operands as the kernel reads them ----------------------------------------
# Both kernels read x and y through TMA, which needs a 16-byte aligned base
# and a row stride of a multiple of 16 bytes: an operand without both
# (tma_unfit) is padded, counted, in every dtype.  Checked on CPU tensors,
# with the launch stubbed where the wrapper's card route runs.

def _at(rows, cols, dtype, offset=0):
  """A (rows, cols) tensor of seeded values whose base is ``offset``
  elements past a 16-byte aligned one."""
  flat = torch.zeros(rows * cols + 8, dtype=dtype)
  flat[offset:offset + rows * cols] = torch.from_numpy(
      np.random.default_rng(rows * cols + offset).standard_normal(
          rows * cols).astype(np.float32)).to(dtype)
  return flat[offset:offset + rows * cols].view(rows, cols)


# (dtype, x (m, k, base offset), y's (n, base offset), x padded, y padded)
OPERAND_CASES = [
    ("float32", (5, 8, 0), (8, 0), False, False),
    ("float32", (5, 7, 0), (8, 0), True, False),     # K % 4 != 0
    ("float32", (5, 8, 0), (5, 0), False, True),     # N % 4 != 0
    ("float32", (5, 8, 1), (8, 0), True, False),     # x 4 bytes off
    ("float32", (5, 8, 0), (8, 1), False, True),     # y 4 bytes off
    ("float32", (5, 1001, 3), (1001, 2), True, True),
    ("bfloat16", (5, 7, 0), (8, 0), True, False),
    ("bfloat16", (5, 8, 0), (5, 0), False, True),
    ("bfloat16", (5, 8, 1), (9, 1), True, True),
    ("float16", (5, 8, 0), (8, 0), False, False),
]


@pytest.mark.parametrize("case", OPERAND_CASES, ids=str)
def test_kernel_operands_pad_what_tma_cannot_read(case):
  dtype, (m, k, xoff), (n, yoff), x_padded, y_padded = case
  dtype = getattr(torch, dtype)
  x, y = _at(m, k, dtype, xoff), _at(k, n, dtype, yoff)
  before = K2.counts["padded_operands"]
  xk, yk = K2.kernel_operands(x, y)
  assert K2.counts["padded_operands"] - before == x_padded + y_padded
  for t, got, padded in ((x, xk, x_padded), (y, yk, y_padded)):
    assert got.is_contiguous() and got.dtype == t.dtype
    assert torch.equal(got[:, :t.shape[1]], t)
    if padded:
      assert not K2.tma_unfit(got) and not got[:, t.shape[1]:].any()
    else:
      assert got.shape == t.shape and got.data_ptr() == t.data_ptr()


class _Recorder:
  """``build.launch`` recording K2's arguments and launching nothing."""

  def __init__(self):
    self.calls = []

  def __call__(self, name, device, x, ldx, y, ldy, out, m, n, k, in_code,
               out_code, program):
    assert name == "matmul"
    self.calls.append(dict(ldx=ldx, ldy=ldy, m=m, n=n, k=k,
                           codes=(in_code, out_code),
                           program=program is not None))


# (x, y, epilogue, expected arguments, padded operands, unfused epilogues)
def _route_cases():
  f32, bf16 = torch.float32, torch.bfloat16
  wide = _at(6, 20, f32)
  return [
      ("f32", _at(5, 8, f32), _at(8, 8, f32), None,
       dict(ldx=8, ldy=8, m=5, n=8, k=8, codes=(1, 1), program=False), 0, 0),
      ("f32_k7_n5_relu", _at(5, 7, f32), _at(7, 5, f32), _relu,
       dict(ldx=8, ldy=8, m=5, n=5, k=7, codes=(1, 1), program=True), 2, 0),
      ("f32_k0", _at(5, 0, f32), _at(0, 5, f32), None,
       dict(ldx=0, ldy=5, m=5, n=5, k=0, codes=(1, 1), program=False), 0, 0),
      ("f32_view", wide[:, 3:11], _at(8, 12, f32), None,
       dict(ldx=8, ldy=12, m=6, n=12, k=8, codes=(1, 1), program=False), 0,
       0),
      ("f64_cast", _at(5, 7, f32).double(), _at(7, 3, f32).double(), None,
       dict(ldx=8, ldy=4, m=5, n=3, k=7, codes=(1, 1), program=False), 2, 0),
      ("bf16_tanh", _at(5, 7, bf16), _at(7, 8, bf16), torch.tanh,
       dict(ldx=8, ldy=8, m=5, n=8, k=7, codes=(2, 2), program=True), 1, 0),
      ("bf16_sigmoid", _at(5, 7, bf16), _at(7, 8, bf16), torch.sigmoid,
       dict(ldx=8, ldy=8, m=5, n=8, k=7, codes=(2, 1), program=False), 1, 1),
  ]


@pytest.mark.parametrize("case", _route_cases(), ids=lambda c: c[0])
def test_kernel_route_passes_the_ready_operands(case, monkeypatch):
  label, x, y, epilogue, want, padded, unfused = case
  rec = _Recorder()
  monkeypatch.setattr(K2.build, "launch", rec)
  before = dict(K2.counts)
  out = K2._launch(x, y, epilogue)
  assert rec.calls == [want]
  assert K2.counts == dict(before, launches=before["launches"] + 1,
                           padded_operands=before["padded_operands"] + padded,
                           epilogue_unfused=before["epilogue_unfused"]
                           + unfused)
  assert out.shape == (x.shape[0], y.shape[1]) and out.dtype == x.dtype


def test_float32_route_has_no_row_cap(monkeypatch):
  """The float32 kernel walks a 1-D list of tiles: the wrapper hands it
  more than 65535 tiles of rows (65535 · 128 + 1 rows, on the meta device:
  no data) without a bound of its own."""
  rec = _Recorder()
  monkeypatch.setattr(K2.build, "launch", rec)
  m = 65535 * 128 + 1
  x = torch.empty((m, 4), device="meta")
  y = torch.empty((4, 4), device="meta")
  out = K2._launch(x, y, None)
  assert out.shape == (m, 4)
  assert rec.calls == [dict(ldx=4, ldy=4, m=m, n=4, k=4, codes=(1, 1),
                            program=False)]
