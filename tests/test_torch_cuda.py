"""Card-only tests of the port: kernel K1 (csrc/fused_reduce.cu) against
its plain torch version on the same CUDA tensors, and the expression
layer's kernel path.  Run on a machine with an NVIDIA GPU:

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
