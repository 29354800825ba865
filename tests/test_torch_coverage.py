"""The port's coverage of the reference's public names (ROADMAP Queue 1,
item 1.5): the exact sorted list of ``spartan_tpu.__all__`` names that
``spartan_tpu_torch`` does not export yet.  A PR that ports a name must
take it off this list; the round ends when the list is empty."""

import spartan_tpu as ref

import spartan_tpu_torch as sp

MISSING = sorted("""
checkpoint cluster compile cond fft from_file grad hessian hvp integrate
interpolate jvp linalg load minimize ndimage optimize random remat save
scan_iters scipy_linalg sgd_train signal smart_tile sparse_linalg spatial
special stats tiling_plan value_and_grad while_loop
""".split())


def test_the_names_the_port_still_lacks():
  lacking = sorted(set(ref.__all__) - set(sp.__all__))
  assert lacking == MISSING
  assert len(MISSING) == 32


def test_every_exported_name_is_defined():
  for name in sp.__all__:
    assert hasattr(sp, name), name
  assert len(set(sp.__all__)) == 370
