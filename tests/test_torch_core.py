"""The port's substrate against the reference: flags, extent algebra, the
one-device mesh and tiling, and exact dtype round trips of arrays."""

import numpy as np
import pytest
import torch

from spartan_tpu.config import Flags as RefFlags, BoolFlag as RefBool, \
    IntFlag as RefInt
from spartan_tpu.core import extent as ref_extent

import spartan_tpu_torch as sp
from spartan_tpu_torch.config import BoolFlag, Flags, IntFlag
from spartan_tpu_torch.core import extent
from spartan_tpu_torch.core.array import from_numpy
from spartan_tpu_torch.core.mesh import make_mesh, with_mesh
from spartan_tpu_torch.core.tiling import Tiling


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _geom(e):
  return None if e is None else (e.ul, e.lr, e.array_shape)


EXTENT_CASES = {
    "intersection": lambda m: m.intersection(
        m.create((1, 2), (5, 7), (8, 8)), m.create((3, 0), (8, 4), (8, 8))),
    "disjoint": lambda m: m.intersection(
        m.create((0, 0), (2, 2), (8, 8)), m.create((4, 4), (6, 6), (8, 8))),
    "from_slice": lambda m: m.from_slice((slice(1, 5), 3), (8, 9)),
    "from_slice_ellipsis": lambda m: m.from_slice((Ellipsis, slice(-3, None)),
                                                 (4, 5, 6)),
    "compute_slice": lambda m: m.compute_slice(
        m.create((2, 2), (6, 8), (10, 10)), (slice(1, 3), slice(None))),
    "offset_from": lambda m: m.offset_from(
        m.create((2, 2), (6, 8), (10, 10)), m.create((3, 4), (5, 8), (10, 10))),
    "shift_clip": lambda m: m.shift(m.create((0, 0), (3, 3), (5, 5)), (-1, 4)),
    "drop_axis": lambda m: m.create((1, 2, 3), (2, 4, 6), (4, 5, 6)).drop_axis(1),
    "transpose": lambda m: m.create((1, 2, 3), (2, 4, 6), (4, 5, 6)).transpose(),
}


@pytest.mark.parametrize("case", sorted(EXTENT_CASES))
def test_extent_algebra_matches_reference(case):
  assert _geom(EXTENT_CASES[case](extent)) == _geom(
      EXTENT_CASES[case](ref_extent))


@pytest.mark.parametrize("shape", [(7,), (3, 4), (2, 3, 5)], ids=str)
def test_ravel_unravel_match_reference(shape):
  for i in range(int(np.prod(shape))):
    pt = extent.unravelled_pos(i, shape)
    assert pt == ref_extent.unravelled_pos(i, shape)
    assert extent.ravelled_pos(pt, shape) == i
  e = extent.create((1,) * len(shape), shape, shape)
  assert e.to_global(0) == ref_extent.create(
      (1,) * len(shape), shape, shape).to_global(0)


def test_flags_parse_like_reference():
  argv = ["--alpha=3", "--nobeta", "pos", "--gamma", "--unknown=1"]
  ours, ref = Flags(), RefFlags()
  for f in (ours, ref):
    mod = (IntFlag, BoolFlag) if f is ours else (RefInt, RefBool)
    f.add(mod[0]("alpha", 1))
    f.add(mod[1]("beta", True))
    f.add(mod[1]("gamma", False))
  assert ours.parse(argv) == ref.parse(argv)
  assert ours.snapshot() == ref.snapshot()


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16,
                                   np.int64, np.int32, np.int8, np.uint8,
                                   np.bool_, np.complex128], ids=str)
def test_from_numpy_round_trips_exactly(dtype):
  host = (np.arange(12).reshape(3, 4) % 3).astype(dtype)
  arr = from_numpy(host)
  out = arr.glom()
  assert out.dtype == host.dtype and arr.shape == host.shape
  np.testing.assert_array_equal(out, host)
  host[0, 0] = 2  # the device copy does not alias the host array
  assert arr.glom()[0, 0] == 0


def test_mesh_and_tiling_are_one_device():
  mesh = make_mesh("cpu")
  assert mesh.size == 1 and mesh.devices == (torch.device("cpu"),)
  tiling = Tiling(mesh)
  assert tiling.spec == () and tiling.extents((4, 6)) == [
      extent.from_shape((4, 6))]
  with with_mesh(mesh):
    assert sp.get_mesh() is mesh
  with pytest.raises(ValueError, match="unsupported mesh device"):
    make_mesh("meta")
