"""Array files and checkpoints in both packages: the counterparts of the
reference's ``tests/test_fio.py`` (its one-process cases).  A file either
package saves, the other loads bit for bit, both ways, whatever the
reference's mesh cuts the array into; a checkpoint saves once and restores
instead of recomputing; a crash mid-save leaves no manifest.  Exact
comparisons throughout: nothing is computed but the values written.
"""

import json
import os

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.expr import fio as ref_fio

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio

DTYPES = [np.float64, np.float32, np.int32, np.int64, np.bool_,
          np.complex128]


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _data(rng, shape, dtype):
  x = rng.standard_normal(shape) * 100
  if np.dtype(dtype).kind == "c":
    return (x + 1j * rng.standard_normal(shape)).astype(dtype)
  if dtype == np.bool_:
    return x > 0
  return x.astype(dtype)


def test_save_load_roundtrip(rng, tmp_path):
  a = rng.standard_normal((16, 24))
  path = str(tmp_path / "arr")
  sp.save(sp.from_numpy(a).evaluate(), path)
  assert os.path.exists(os.path.join(path, "manifest.json"))
  back = sp.load(path)
  assert back.dtype == torch.float64
  np.testing.assert_array_equal(back.glom(), a)


def test_save_expr(rng, tmp_path):
  a = rng.standard_normal((8, 8))
  path = str(tmp_path / "expr")
  sp.save(sp.from_numpy(a) * 2.0, path)
  np.testing.assert_array_equal(sp.load(path).glom(), a * 2.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(16, 24), (7, 5), (33,), (4, 6, 10)])
def test_files_cross_between_the_packages(rng, tmp_path, dtype, shape):
  """The reference's shards (its 8-device mesh cuts the array into
  several) load into the port bit for bit, and the port's one shard loads
  into the reference bit for bit."""
  a = _data(rng, shape, dtype)
  ref_path = str(tmp_path / "from_ref")
  ref_fio.save(ref.from_numpy(a).evaluate(), ref_path)
  got = sp.load(ref_path)
  assert got.glom().dtype == a.dtype
  np.testing.assert_array_equal(got.glom(), a)
  port_path = str(tmp_path / "from_port")
  sp.save(sp.from_numpy(a), port_path)
  back = ref_fio.load(port_path)
  assert np.asarray(back.glom()).dtype == a.dtype
  np.testing.assert_array_equal(np.asarray(back.glom()), a)


def test_the_manifest_is_the_references_format(rng, tmp_path):
  a = rng.standard_normal((6, 4)).astype(np.float32)
  path = str(tmp_path / "m")
  sp.save(sp.from_numpy(a), path)
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)
  assert manifest == {"shape": [6, 4], "dtype": "float32",
                      "mesh_shape": {"x": 1}, "spec": [], "num_shards": 1,
                      "shards": [{"ul": [0, 0], "lr": [6, 4]}]}
  assert sorted(os.listdir(path)) == ["manifest.json", "shard_00000.npy"]


def test_bfloat16_is_written_as_float32(tmp_path):
  x = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7
  path = str(tmp_path / "bf16")
  sp.save(sp.Val(sp.SpartanArray(x.to(torch.bfloat16))), path)
  back = sp.load(path)
  assert back.dtype == torch.float32
  np.testing.assert_array_equal(back.glom(),
                                x.to(torch.bfloat16).float().numpy())


def test_checkpoint_computes_then_restores(rng, tmp_path):
  a = rng.standard_normal((8, 8))
  path = str(tmp_path / "ckpt")
  r1 = sp.checkpoint(sp.from_numpy(a) + 1.0, path).glom()
  np.testing.assert_array_equal(r1, a + 1.0)
  # a fresh expr (a fresh lineage) restores from disk, not recomputing
  r2 = sp.checkpoint(sp.from_numpy(np.zeros_like(a)) + 123.0, path).glom()
  np.testing.assert_array_equal(r2, r1)


def test_checkpoint_in_larger_dag(rng, tmp_path):
  a = rng.standard_normal((8, 8))
  path = str(tmp_path / "ckpt2")
  ck = sp.checkpoint(sp.from_numpy(a) * 3.0, path)
  out = (ck + 1.0).sum()
  np.testing.assert_allclose(out.glom(), (a * 3.0 + 1.0).sum(), rtol=1e-14)
  assert isinstance(ck._cache, sp.SpartanArray)  # taken before the region
  want = (ref_fio.checkpoint(ref.from_numpy(a) * 3.0,
                             str(tmp_path / "ckpt2_ref")) + 1.0).sum()
  np.testing.assert_allclose(out.glom(), want.glom(), rtol=1e-14)


def test_checkpoints_cross_between_the_packages(rng, tmp_path):
  a = rng.standard_normal((12, 5))
  path = str(tmp_path / "shared")
  ref_fio.checkpoint(ref.from_numpy(a) * 2.0, path).glom()
  got = sp.checkpoint(sp.from_numpy(np.zeros_like(a)), path).glom()
  np.testing.assert_array_equal(got, a * 2.0)
  path2 = str(tmp_path / "shared2")
  sp.checkpoint(sp.from_numpy(a) - 1.0, path2).glom()
  back = ref_fio.checkpoint(ref.from_numpy(np.zeros_like(a)), path2).glom()
  np.testing.assert_array_equal(np.asarray(back), a - 1.0)


def test_from_file(rng, tmp_path):
  a = rng.standard_normal((6, 6))
  p = str(tmp_path / "x.npy")
  np.save(p, a)
  np.testing.assert_array_equal(sp.from_file(p).glom(), a)
  np.testing.assert_array_equal(sp.expr.from_file(p).glom(),
                                np.asarray(ref.expr.from_file(p).glom()))
  d = str(tmp_path / "dir")
  sp.save(sp.from_numpy(a), d)
  np.testing.assert_array_equal((sp.from_file(d) + 0.0).glom(), a)


def test_crash_mid_save_leaves_no_manifest(rng, tmp_path, monkeypatch):
  """The manifest is written last, so a crash mid-save never leaves a
  manifest pointing at missing shards; a checkpoint over that path then
  recomputes."""
  a = rng.standard_normal((16, 8))
  path = str(tmp_path / "crash")
  real_save = np.save

  def failing_save(f, *args, **kw):
    raise OSError("disk full (simulated)")

  monkeypatch.setattr(np, "save", failing_save)
  with pytest.raises(OSError):
    sp.save(sp.from_numpy(a), path)
  monkeypatch.setattr(np, "save", real_save)
  assert not os.path.exists(os.path.join(path, "manifest.json"))
  assert not any(n.startswith("shard_") for n in os.listdir(path))
  ck = sp.checkpoint(sp.from_numpy(a) * 2.0, path)
  np.testing.assert_array_equal(ck.glom(), a * 2.0)
  # and the reference reads what the recompute wrote
  np.testing.assert_array_equal(np.asarray(ref_fio.load(path).glom()),
                                a * 2.0)


def test_a_stale_checkpoint_warns_and_restores(rng, tmp_path, monkeypatch):
  path = str(tmp_path / "stale")
  sp.save(sp.from_numpy(rng.standard_normal((3, 3))), path)
  seen = []
  monkeypatch.setattr(fio, "log_warn", lambda *a: seen.append(a))
  got = sp.checkpoint(sp.from_numpy(np.zeros((4, 4))), path).evaluate()
  assert got.shape == (3, 3) and seen
