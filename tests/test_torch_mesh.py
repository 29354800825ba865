"""The port's mesh of logical shards, against the reference's mesh over the
virtual CPU devices of tests/conftest.py: ``make_mesh`` shapes and
``--mesh_shape``, ``_best_2d_factors``, and the region cache's key.  Dense
arrays stay whole tensors, replicated over the shards: their tiling is the
mesh with an empty spec and one extent.  Exact: these are integer
metadata.
"""

import jax
import numpy as np
import pytest
import torch

from spartan_tpu.core import mesh as ref_mesh

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.evaluator import flags_key
from spartan_tpu_torch.core import mesh as mesh_mod
from spartan_tpu_torch.core.array import from_numpy
from spartan_tpu_torch.core import tiling

MESH_SHAPES = [(1,), (2,), (3,), (4,), (8,), (2, 2), (2, 4), (4, 2)]


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _ref_mesh(shape):
  n = int(np.prod(shape))
  return ref_mesh.make_mesh(shape, ("x", "y")[:len(shape)],
                            devices=jax.devices()[:n])


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_make_mesh_gives_p_shards_of_one_device(p):
  mesh = sp.make_mesh("cpu", shape=(p,))
  assert mesh.size == p == mesh_mod.num_devices(mesh)
  assert mesh.devices == (torch.device("cpu"),) * p
  assert mesh.axis_names == ("x",) and mesh.shape == {"x": p}
  with sp.with_mesh(mesh):
    assert sp.get_mesh() is mesh and mesh_mod.num_devices() == p


@pytest.mark.parametrize("n", [1, 2, 6, 7, 8, 12, 16])
def test_a_shard_count_factors_as_the_reference_does(n):
  assert mesh_mod._best_2d_factors(n) == ref_mesh._best_2d_factors(n)
  mesh = sp.make_mesh("cpu", shape=n)
  assert tuple(mesh.shape.values()) == ref_mesh._best_2d_factors(n)
  assert mesh.axis_names == ("x", "y")


def test_the_mesh_shape_flag_sets_the_default_mesh():
  flag = sp.FLAGS.lookup("mesh_shape")
  try:
    sp.initialize(["--device=cpu", "--mesh_shape=2x4"])
    mesh = sp.get_mesh()
    assert mesh.shape == {"x": 2, "y": 4} and mesh.size == 8
    assert sp.make_mesh("cpu").shape == {"x": 2, "y": 4}
    assert sp.make_mesh("cpu", shape=(3,)).size == 3  # the argument wins
  finally:
    flag.reset()
    sp.initialize(["--device=cpu"])
  assert sp.get_mesh().size == 1 and sp.get_mesh().shape == {"x": 1}


def test_mesh_equality_and_hash_include_the_shape():
  a, b = sp.make_mesh("cpu", shape=(2,)), sp.make_mesh("cpu", shape=(2,))
  c, d = sp.make_mesh("cpu", shape=(4,)), sp.make_mesh("cpu", shape=(2, 2))
  assert a == b and hash(a) == hash(b)
  assert a != c and a != d and c != d
  assert len({a, b, c, d}) == 3
  with pytest.raises(ValueError, match="positive sizes"):
    sp.make_mesh("cpu", shape=(0,))
  with pytest.raises(ValueError, match="unsupported mesh device"):
    sp.make_mesh("meta", shape=(2,))


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES, ids=str)
def test_mesh_vocabulary_matches_the_reference(mesh_shape):
  rmesh = _ref_mesh(mesh_shape)
  mesh = sp.make_mesh("cpu", shape=mesh_shape)
  assert mesh.axis_names == tuple(rmesh.axis_names)
  assert mesh.shape == dict(rmesh.shape)
  assert mesh.size == rmesh.size == len(mesh.devices)
  assert mesh_mod.num_devices(mesh) == ref_mesh.num_devices(rmesh)


def test_the_region_cache_keys_on_the_mesh_shape():
  keys = {flags_key(sp.make_mesh("cpu", shape=s)) for s in MESH_SHAPES}
  assert len(keys) == len(MESH_SHAPES)
  assert flags_key(sp.make_mesh("cpu", shape=(2,))) == flags_key(
      sp.make_mesh("cpu", shape=(2,)))


@pytest.mark.parametrize("hint", [None, (4, 8), (16, 16)], ids=str)
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES, ids=str)
def test_arrays_on_a_mesh_are_whole_and_replicated(mesh_shape, hint):
  mesh = sp.make_mesh("cpu", shape=mesh_shape)
  host = np.arange(16 * 16, dtype=np.float64).reshape(16, 16)
  with sp.with_mesh(mesh):
    made = from_numpy(host, tile_hint=hint)
    out = (made * 2).evaluate()
  for arr in (made, out):
    assert arr.tiling == tiling.auto_tiling(arr.shape, hint, mesh)
    assert arr.tiling.mesh == mesh and arr.tiling.spec == ()
    assert [(e.ul, e.lr) for e in arr.tiling.extents(arr.shape)] == [
        ((0, 0), (16, 16))]
    assert tuple(arr.data.shape) == (16, 16)
  np.testing.assert_array_equal(out.glom(), 2 * host)


def test_evaluated_arrays_carry_the_mesh_and_stay_whole():
  with sp.with_mesh(sp.make_mesh("cpu", shape=(2, 4))):
    big = (sp.ones((64, 512)) * 2).evaluate()
    small = (sp.ones((3,)) + 1).evaluate()
  assert big.tiling.mesh.size == 8 and big.tiling.spec == ()
  assert len(big.tiling.extents(big.shape)) == 1
  assert tuple(big.data.shape) == (64, 512)
  assert small.tiling == big.tiling
  np.testing.assert_array_equal(big.glom(), np.full((64, 512), 2.0))
