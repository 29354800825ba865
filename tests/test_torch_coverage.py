"""The port's coverage of the reference's public names (ROADMAP Queue 1,
item 1.5): the exact sorted list of ``spartan_tpu.__all__`` names that
``spartan_tpu_torch`` does not export yet.  A PR that ports a name must
take it off this list; the round ends when the list is empty."""

import spartan_tpu as ref

import spartan_tpu_torch as sp

MISSING = sorted("""
DictExpr TupleExpr amax amin append apply_along_axis apply_over_axes
argpartition argsort array_split atleast_1d atleast_2d atleast_3d average
block broadcast_arrays broadcast_to checkpoint choice cluster column_stack
compile concat concatenate cond convolve corrcoef correlate cov cross
cummax cummin cumprod cumsum delete diag diagflat diff digitize dsplit
dstack ediff1d einsum einsum_path fft fill_diagonal flip fliplr flipud
from_file gradient grad hessian histogram histogram2d
histogram_bin_edges histogramdd hsplit hstack hvp inner insert integrate
interp interpolate jvp kron lexsort linalg load matmul matrix_transpose
median minimize moveaxis msort nanargmax nanargmin nancumprod nancumsum
nanmedian nanpercentile nanprod nanquantile ndimage norm optimize
packbits pad partition percentile permutation permute_dims poly polyadd
polyder polydiv polyfit polyint polymul polysub polyval ptp quantile
random remat roll rollaxis roots rot90 save scan scan_iters scipy_linalg
searchsorted sgd_train signal smart_tile sort sort_complex sparse_linalg
spatial special split stack stats take_along_axis tensordot tile
tiling_plan trapezoid trapz tril triu unpackbits unwrap value_and_grad
vander vdot vecdot vsplit vstack while_loop
""".split())


def test_the_names_the_port_still_lacks():
  lacking = sorted(set(ref.__all__) - set(sp.__all__))
  assert lacking == MISSING
  assert len(MISSING) == 143


def test_every_exported_name_is_defined():
  for name in sp.__all__:
    assert hasattr(sp, name), name
  assert len(set(sp.__all__)) == 259
