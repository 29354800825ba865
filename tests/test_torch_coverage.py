"""The port's coverage of the reference's public names (ROADMAP Queue 1,
item 1.5): the exact sorted list of ``spartan_tpu.__all__`` names that
``spartan_tpu_torch`` does not export yet, and of
``spartan_tpu.sparse_linalg.__all__`` names that
``spartan_tpu_torch.sparse_linalg`` lacks; ``sp.sparse``'s constructors,
``sp.sparse.csgraph``, ``sp.optimize``, ``sp.integrate`` and
``sp.special``, ``sp.stats``, ``sp.signal``, ``sp.ndimage`` and
``sp.spatial`` with its ``distance`` and ``transform``; the ``learn``
estimators and the example modules.
A change that ports a name must take it off its list; the port is whole
when both lists are empty."""

import spartan_tpu as ref
import spartan_tpu.sparse_linalg as ref_spl

import spartan_tpu_torch as sp
import spartan_tpu_torch.sparse_linalg as spl

MISSING = sorted("""
cluster interpolate smart_tile tiling_plan
""".split())

# every name of the reference's sparse_linalg is ported
MISSING_SPARSE_LINALG = []


def test_the_names_the_port_still_lacks():
  lacking = sorted(set(ref.__all__) - set(sp.__all__))
  assert lacking == MISSING
  assert len(MISSING) == 4


def test_every_exported_name_is_defined():
  for name in sp.__all__:
    assert hasattr(sp, name), name
  assert len(set(sp.__all__)) == 398


def test_the_sparse_linalg_names_the_port_still_lacks():
  lacking = sorted(set(ref_spl.__all__) - set(spl.__all__))
  assert lacking == MISSING_SPARSE_LINALG
  assert len(MISSING_SPARSE_LINALG) == 0
  assert set(spl.__all__) <= set(ref_spl.__all__)
  for name in spl.__all__:
    assert hasattr(spl, name), name


def test_sp_sparse_has_every_builder_of_the_reference():
  """``sp.sparse`` carries every name of the reference's
  ``sparse_construct.__all__``, the port's own builders."""
  import spartan_tpu.sparse_construct as ref_sc

  import spartan_tpu_torch.sparse_construct as sc
  for name in ref_sc.__all__:
    assert getattr(sp.sparse, name) is getattr(sc, name), name


def test_sp_sparse_csgraph_has_every_name_of_the_reference():
  """``sp.sparse.csgraph`` is the port's ``csgraph`` and carries every name
  of the reference's ``csgraph.__all__`` (23), and no other."""
  import spartan_tpu.csgraph as ref_cg

  import spartan_tpu_torch.csgraph as cg
  assert sp.sparse.csgraph is cg
  assert sorted(cg.__all__) == sorted(ref_cg.__all__)
  assert len(ref_cg.__all__) == 23
  for name in ref_cg.__all__:
    assert hasattr(sp.sparse.csgraph, name), name


def test_sp_optimize_has_every_name_of_the_reference():
  """``sp.optimize`` carries the 69 names of the reference's
  ``optimize.__all__``, and no other."""
  import spartan_tpu.optimize as ref_opt

  import spartan_tpu_torch.optimize as opt
  assert sp.optimize is opt
  assert sorted(opt.__all__) == sorted(ref_opt.__all__)
  assert len(ref_opt.__all__) == 69
  for name in ref_opt.__all__:
    assert hasattr(sp.optimize, name), name


def test_sp_integrate_has_every_name_of_the_reference():
  """``sp.integrate`` carries the 34 names of the reference's
  ``integrate.__all__``, and no other."""
  import spartan_tpu.integrate as ref_int

  import spartan_tpu_torch.integrate as integ
  assert sp.integrate is integ
  assert sorted(integ.__all__) == sorted(ref_int.__all__)
  assert len(ref_int.__all__) == 34
  for name in ref_int.__all__:
    assert hasattr(sp.integrate, name), name


def test_sp_special_has_every_name_of_the_reference():
  """``sp.special`` carries every name of the reference's
  ``special.__all__`` (which depends on the installed scipy: both are
  computed here against the same one), and no other; its host names are
  the reference's."""
  import spartan_tpu.special as ref_special

  import spartan_tpu_torch.special as special
  assert sp.special is special
  assert special.__all__ == ref_special.__all__
  assert special._HOST_NAMES == ref_special._HOST_NAMES
  assert len(set(special.__all__) - set(special._HOST_NAMES)) == 116
  for name in ref_special.__all__:
    assert hasattr(sp.special, name), name


def test_sp_stats_and_sp_signal_have_every_name_of_the_reference():
  """``sp.stats``'s ``__all__`` and ``_HOST_NAMES`` and ``sp.signal``'s
  ``__all__`` (157 names) are the reference's, computed in this process
  against the same scipy."""
  import spartan_tpu.signal as ref_signal
  import spartan_tpu.stats as ref_stats

  import spartan_tpu_torch.signal as signal
  import spartan_tpu_torch.stats as stats
  assert sp.stats is stats and sp.signal is signal
  assert stats.__all__ == ref_stats.__all__
  assert stats._HOST_NAMES == ref_stats._HOST_NAMES
  assert signal.__all__ == ref_signal.__all__
  assert len(signal.__all__) == 157
  for mod, ref_mod in ((stats, ref_stats), (signal, ref_signal)):
    for name in ref_mod.__all__:
      assert hasattr(mod, name), name


def test_sp_ndimage_and_sp_spatial_have_every_name_of_the_reference():
  """``sp.ndimage`` (75 names), ``sp.spatial`` (17), ``sp.spatial.distance``
  (29) and ``sp.spatial.transform`` (4) export the reference's ``__all__``;
  the Qhull family and ``RotationSpline``/``RigidTransform`` are scipy's own
  objects, as the reference re-exports them."""
  import scipy.spatial as ssp
  import scipy.spatial.transform as sst

  import spartan_tpu.ndimage as ref_nd
  import spartan_tpu.spatial as ref_spatial
  import spartan_tpu.spatial_distance as ref_dist
  import spartan_tpu.spatial_transform as ref_tr

  import spartan_tpu_torch.ndimage as nd
  import spartan_tpu_torch.spatial as spatial
  import spartan_tpu_torch.spatial_distance as dist
  import spartan_tpu_torch.spatial_transform as tr
  assert sp.ndimage is nd and sp.spatial is spatial
  assert sp.spatial.distance is dist and sp.spatial.transform is tr
  for mod, ref_mod, n in ((nd, ref_nd, 75), (spatial, ref_spatial, 17),
                          (dist, ref_dist, 29), (tr, ref_tr, 4)):
    assert mod.__all__ == ref_mod.__all__
    assert len(mod.__all__) == n
    for name in ref_mod.__all__:
      assert hasattr(mod, name), name
  assert spatial._HOST_NAMES == ref_spatial._HOST_NAMES
  for name in spatial._HOST_NAMES:
    assert getattr(sp.spatial, name) is getattr(ssp, name), name
  assert tr._HOST_NAMES == ref_tr._HOST_NAMES
  assert sp.spatial.transform.RotationSpline is sst.RotationSpline
  assert sp.spatial.transform.RigidTransform is sst.RigidTransform


def test_learn_and_the_examples_match_the_reference():
  """``spartan_tpu_torch.learn`` exports the reference's 14 estimators; the
  example modules are the reference's, none waiting
  (``examples.__main__.WAITING`` is empty), and each has its CLI runner."""
  import pkgutil

  import spartan_tpu.examples as ref_examples
  import spartan_tpu.learn as ref_learn

  import spartan_tpu_torch.examples as examples
  import spartan_tpu_torch.learn as learn
  from spartan_tpu_torch.examples.__main__ import WAITING
  assert learn.__all__ == ref_learn.__all__
  assert len(learn.__all__) == 14
  mods = {m.name for m in pkgutil.iter_modules(examples.__path__)}
  ref_mods = {m.name for m in pkgutil.iter_modules(ref_examples.__path__)}
  assert mods == ref_mods
  assert WAITING == ()
  from spartan_tpu.examples.__main__ import _RUNNERS as REF_RUNNERS

  from spartan_tpu_torch.examples.__main__ import _RUNNERS
  assert sorted(_RUNNERS) == sorted(REF_RUNNERS)
