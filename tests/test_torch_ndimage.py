"""``sp.ndimage`` of the port (``spartan_tpu_torch/ndimage.py``) against
scipy.ndimage and the reference's (``spartan_tpu/ndimage.py``) on its
8-device mesh, float64 on seeded inputs: each case held to scipy and to the
reference at rtol 1e-10 (atol 1e-12 for values of order one; exact for
labels, positions and binary images).  Where the reference differs from
scipy (``REFERENCE_DEFECTS``) the port is held to scipy alone and the
reference to its difference; where the port keeps the reference's value and
scipy's differs (``SCIPY_DIFFERS``) the port is held to the reference.
Then the integer and float32 dtypes, the loops' counts, the host
boundaries' counts, K1 under ``sum_labels`` of a float32 image, and a
dispatch-mode audit that no measurement builds a tensor of labels × pixels.
About 60 s serial on one core, most of it the reference's compiles.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import ndimage as nd_mod
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.map import MapExpr, is_structural

N, RN = sp.ndimage, ref.ndimage
rng = np.random.default_rng(33)
A = rng.normal(size=(12, 14))
x1 = rng.normal(size=40)
A3 = rng.normal(size=(5, 6, 7))
A4 = rng.normal(size=(3, 4, 5, 6))
w34 = rng.normal(size=(3, 4))
w33 = rng.normal(size=(3, 3))
w5 = rng.normal(size=5)
w4 = rng.normal(size=4)
w323 = rng.normal(size=(3, 2, 3))
w4d = rng.normal(size=(2, 3, 1, 3))
fp = np.array([[1, 0, 1], [0, 1, 0], [1, 0, 1]], bool)
st = np.array([[0.0, 1.0, 0.0], [1.0, 2.0, 1.0], [0.0, 1.0, 0.0]])
B = rng.random((14, 16)) > 0.6
B3 = rng.random((6, 7, 8)) > 0.6
Mask = rng.random((14, 16)) > 0.3
st2 = ndi.generate_binary_structure(2, 2)
s1 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
Ring = np.zeros((9, 9), bool)
Ring[2:7, 2:7] = True
Ring[3:6, 3:6] = False
Seed = np.zeros((9, 9), bool)
Seed[4, 4] = True
Prop = np.zeros((9, 9), bool)
Prop[2:7, 3:6] = True
Prop[8, 8] = True  # not reached from the seed
Bl = rng.random((30, 40)) > 0.6
lab, nlab = ndi.label(Bl)
V = rng.random((30, 40))
V[lab == 1] = 0.4 + 0.2 * V[lab == 1]  # neither extremum of labels > 0
idx = list(range(1, nlab + 1))
Vn = V.copy()
Vn[np.argwhere(lab == 2)[1][0], np.argwhere(lab == 2)[1][1]] = np.nan
Fc = np.fft.fft2(A)
Fr = np.fft.rfft2(A)
coords = np.stack([rng.uniform(-1.5, 12.5, 40), rng.uniform(-1.5, 14.5, 40)])
halves = np.array([[0.5, 1.5, 2.5, -0.5, 3.5, 10.5, -1.5],
                   [0.5, 2.5, 1.5, 0.5, 12.5, 4.5, 2.0]])
coords1 = rng.uniform(-2, 41, (1, 25))
coords3 = np.stack([rng.uniform(0, 4, 20), rng.uniform(0, 5, 20),
                    rng.uniform(0, 6, 20)])
Aff = np.array([[0.9, 0.1], [0.0, 1.1]])
Hom = np.array([[0.95, 0.05, 0.3], [-0.05, 1.02, -0.7], [0.0, 0.0, 1.0]])
Rot = rng.normal(size=(20, 25))  # the reference's shape (29, 31), scipy's (30, 32)
MODES = ("reflect", "grid-mirror", "mirror", "nearest", "wrap",
         "grid-wrap", "constant", "grid-constant")


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def g(e):
  """A result as one float array: exprs evaluated, tuples and lists
  (positions, extrema, label's pair) flattened and joined."""
  if hasattr(e, "glom"):
    e = np.asarray(e.glom())
  if isinstance(e, (tuple, list)):
    parts = [np.ravel(g(v)).astype(float) for v in e]
    return np.concatenate(parts) if parts else np.zeros(0)
  e = np.asarray(e)
  return e.astype(np.int64) if e.dtype == bool else e


def _d2(M):
  return lambda x, ax, out, m, cv: M.correlate1d(x, [1.0, -2.0, 1.0], ax,
                                                 out, m, cv)


def _mean_of(M):
  if M is N:
    return torch.mean
  import jax.numpy as jnp
  return jnp.mean


# where the reference differs from scipy the port is held to scipy alone
# and the reference to its difference: "differs" (its value is not within
# the tolerance of scipy's, or has another shape) or the error it raises.
#  - percentile_filter ranks int(p (n - 1) / 100 + 0.5); scipy int(n p / 100)
#  - rotate(reshape=True) sizes the output from the corners at n - 1 with
#    ceil; scipy from the corners at n with int(ptp + 0.5)
#  - a NaN in one label reaches every label's sum, mean, variance and centre
#    of mass through the reference's one-hot product (NaN * 0)
#  - labels without index: minimum/maximum/*_position/center_of_mass take
#    label 1; scipy takes every label above 0 as one region
#  - binary_erosion(iterations < 1) erodes once; scipy erodes until nothing
#    changes
#  - laplace of a 0-d input raises ZeroDivisionError (an axis modulo 0)
#    and generic_gradient_magnitude ValueError (the square root of no
#    term); scipy returns the input
REFERENCE_DEFECTS = {
    "laplace_0d": ZeroDivisionError,
    "generic_gradient_magnitude_0d": ValueError,
    "binary_erosion_to_stability": "differs",
    "percentile_filter_30_size4": "differs",
    "rotate_reshape": "differs",
    "sum_labels_nan": "differs", "sum_nan": "differs", "mean_nan": "differs",
    "variance_nan": "differs", "standard_deviation_nan": "differs",
    "center_of_mass_nan": "differs",
    "minimum_labels_no_index": "differs",
    "maximum_labels_no_index": "differs",
    "minimum_position_labels_no_index": "differs",
    "maximum_position_labels_no_index": "differs",
    "extrema_labels_no_index": "differs",
    "center_of_mass_labels_no_index": "differs",
}

# where the port keeps the reference's value and scipy's differs: a NaN in a
# label makes its minimum and its minimum's position the NaN's (np.min's
# rule, the reference's); scipy's minimum skips it
SCIPY_DIFFERS = {"minimum_nan", "minimum_position_nan", "extrema_nan"}


def _c(label, call, want, rtol=1e-10, atol=1e-12):
  return pytest.param(call, want, rtol, atol, REFERENCE_DEFECTS.get(label),
                      label in SCIPY_DIFFERS, id=label)


CASES = []
for _mode in MODES:
  for _o in (0, (-1, 1)):
    _name = f"{_mode}_{'0' if _o == 0 else 'o'}"
    CASES += [
        _c(f"correlate_{_name}",
           lambda M, m=_mode, o=_o: M.correlate(A, w34, mode=m, cval=0.5,
                                                origin=o),
           lambda m=_mode, o=_o: ndi.correlate(A, w34, mode=m, cval=0.5,
                                               origin=o)),
        _c(f"convolve_{_name}",
           lambda M, m=_mode, o=_o: M.convolve(A, w34, mode=m, cval=0.5,
                                               origin=o),
           lambda m=_mode, o=_o: ndi.convolve(A, w34, mode=m, cval=0.5,
                                              origin=o))]
  CASES.append(_c(f"minimum_filter_{_mode}",
                  lambda M, m=_mode: M.minimum_filter(A, size=4, mode=m,
                                                      cval=0.25),
                  lambda m=_mode: ndi.minimum_filter(A, size=4, mode=m,
                                                     cval=0.25)))

CASES += [
    _c("correlate_3x3", lambda M: M.correlate(A, w33),
       lambda: ndi.correlate(A, w33)),
    _c("correlate1d_axis0", lambda M: M.correlate1d(A, w5, axis=0),
       lambda: ndi.correlate1d(A, w5, axis=0)),
    _c("convolve1d_even_origin", lambda M: M.convolve1d(x1, w4, origin=1),
       lambda: ndi.convolve1d(x1, w4, origin=1)),
    _c("correlate1d_1d_wrap",
       lambda M: M.correlate1d(x1, w5, mode="wrap", origin=-2),
       lambda: ndi.correlate1d(x1, w5, mode="wrap", origin=-2)),
    _c("correlate_3d_mirror",
       lambda M: M.correlate(A3, w323, mode="mirror"),
       lambda: ndi.correlate(A3, w323, mode="mirror")),
    _c("convolve_3d_constant",
       lambda M: M.convolve(A3, w323, mode="constant", cval=-1.0),
       lambda: ndi.convolve(A3, w323, mode="constant", cval=-1.0)),
    _c("correlate_4d_nearest",
       lambda M: M.correlate(A4, w4d, mode="nearest"),
       lambda: ndi.correlate(A4, w4d, mode="nearest")),
    _c("uniform_filter", lambda M: M.uniform_filter(A, (3, 5)),
       lambda: ndi.uniform_filter(A, (3, 5))),
    _c("uniform_filter_3d_wrap", lambda M: M.uniform_filter(A3, 4,
                                                            mode="wrap"),
       lambda: ndi.uniform_filter(A3, 4, mode="wrap")),
    _c("uniform_filter1d", lambda M: M.uniform_filter1d(x1, 4, origin=-1),
       lambda: ndi.uniform_filter1d(x1, 4, origin=-1)),
    _c("gaussian_filter", lambda M: M.gaussian_filter(A, 1.5),
       lambda: ndi.gaussian_filter(A, 1.5)),
    _c("gaussian_filter_wide", lambda M: M.gaussian_filter(A, 4.0),
       lambda: ndi.gaussian_filter(A, 4.0)),
    _c("gaussian_filter_orders",
       lambda M: M.gaussian_filter(A, (1.0, 2.0), order=(1, 2)),
       lambda: ndi.gaussian_filter(A, (1.0, 2.0), order=(1, 2))),
    _c("gaussian_filter_3d",
       lambda M: M.gaussian_filter(A3, 1.0, mode="nearest"),
       lambda: ndi.gaussian_filter(A3, 1.0, mode="nearest")),
    _c("gaussian_filter1d_order1",
       lambda M: M.gaussian_filter1d(x1, 2.0, order=1),
       lambda: ndi.gaussian_filter1d(x1, 2.0, order=1)),
    _c("gaussian_filter1d_radius",
       lambda M: M.gaussian_filter1d(x1, 1.0, radius=3, mode="constant",
                                     cval=1.0),
       lambda: ndi.gaussian_filter1d(x1, 1.0, radius=3, mode="constant",
                                     cval=1.0)),
    _c("gaussian_laplace", lambda M: M.gaussian_laplace(A, 1.1),
       lambda: ndi.gaussian_laplace(A, 1.1)),
    _c("gaussian_gradient_magnitude",
       lambda M: M.gaussian_gradient_magnitude(A, 1.1),
       lambda: ndi.gaussian_gradient_magnitude(A, 1.1)),
    _c("laplace", lambda M: M.laplace(A), lambda: ndi.laplace(A)),
    _c("laplace_0d", lambda M: M.laplace(2.5), lambda: ndi.laplace(2.5)),
    _c("generic_gradient_magnitude_0d",
       lambda M: M.generic_gradient_magnitude(2.5, M.sobel),
       lambda: ndi.generic_gradient_magnitude(2.5, ndi.sobel)),
    _c("laplace_3d_mirror", lambda M: M.laplace(A3, mode="mirror"),
       lambda: ndi.laplace(A3, mode="mirror")),
    _c("sobel_0", lambda M: M.sobel(A, 0), lambda: ndi.sobel(A, 0)),
    _c("sobel_1", lambda M: M.sobel(A, 1), lambda: ndi.sobel(A, 1)),
    _c("sobel_3d", lambda M: M.sobel(A3, 2), lambda: ndi.sobel(A3, 2)),
    _c("prewitt_0", lambda M: M.prewitt(A, 0), lambda: ndi.prewitt(A, 0)),
    _c("prewitt_1_constant", lambda M: M.prewitt(A, 1, mode="constant"),
       lambda: ndi.prewitt(A, 1, mode="constant")),
    _c("generic_laplace", lambda M: M.generic_laplace(A, _d2(M)),
       lambda: ndi.generic_laplace(
           A, lambda x, ax, out, m, cv: ndi.correlate1d(
               x, [1.0, -2.0, 1.0], ax, out, m, cv))),
    _c("generic_gradient_magnitude",
       lambda M: M.generic_gradient_magnitude(A, M.sobel),
       lambda: ndi.generic_gradient_magnitude(A, ndi.sobel)),
    _c("maximum_filter_footprint",
       lambda M: M.maximum_filter(A, footprint=fp),
       lambda: ndi.maximum_filter(A, footprint=fp)),
    _c("minimum_filter_origin",
       lambda M: M.minimum_filter(A, footprint=fp, origin=(1, -1)),
       lambda: ndi.minimum_filter(A, footprint=fp, origin=(1, -1))),
    _c("median_filter", lambda M: M.median_filter(A, 3),
       lambda: ndi.median_filter(A, 3)),
    _c("median_filter_even", lambda M: M.median_filter(A, 4),
       lambda: ndi.median_filter(A, 4)),
    _c("median_filter_3d", lambda M: M.median_filter(A3, 3, mode="wrap"),
       lambda: ndi.median_filter(A3, 3, mode="wrap")),
    _c("rank_filter", lambda M: M.rank_filter(A, 2, size=3),
       lambda: ndi.rank_filter(A, 2, size=3)),
    _c("rank_filter_negative", lambda M: M.rank_filter(A, -2, size=3),
       lambda: ndi.rank_filter(A, -2, size=3)),
    _c("percentile_filter_30_3x3",
       lambda M: M.percentile_filter(A, 30, size=(3, 3)),
       lambda: ndi.percentile_filter(A, 30, size=(3, 3))),
    _c("percentile_filter_30_size4",
       lambda M: M.percentile_filter(A, 30, size=4),
       lambda: ndi.percentile_filter(A, 30, size=4)),
    _c("percentile_filter_100", lambda M: M.percentile_filter(A, 100, 3),
       lambda: ndi.percentile_filter(A, 100, 3)),
    _c("minimum_filter1d", lambda M: M.minimum_filter1d(x1, 5),
       lambda: ndi.minimum_filter1d(x1, 5)),
    _c("maximum_filter1d_origin",
       lambda M: M.maximum_filter1d(x1, 4, origin=-1),
       lambda: ndi.maximum_filter1d(x1, 4, origin=-1)),
    _c("maximum_filter1d_axis0_wrap",
       lambda M: M.maximum_filter1d(A, 3, axis=0, mode="wrap"),
       lambda: ndi.maximum_filter1d(A, 3, axis=0, mode="wrap")),
    _c("vectorized_filter",
       lambda M: M.vectorized_filter(A, _mean_of(M), size=3),
       lambda: ndi.vectorized_filter(A, np.mean, size=3)),
]
for _name in ("grey_erosion", "grey_dilation", "grey_opening",
              "grey_closing", "morphological_gradient",
              "morphological_laplace", "white_tophat", "black_tophat"):
  CASES += [
      _c(f"{_name}_size", lambda M, n=_name: getattr(M, n)(A, size=(3, 3)),
         lambda n=_name: getattr(ndi, n)(A, size=(3, 3))),
      _c(f"{_name}_structure",
         lambda M, n=_name: getattr(M, n)(A, structure=st),
         lambda n=_name: getattr(ndi, n)(A, structure=st))]
for _name in ("binary_erosion", "binary_dilation", "binary_opening",
              "binary_closing"):
  CASES += [
      _c(_name, lambda M, n=_name: getattr(M, n)(B),
         lambda n=_name: getattr(ndi, n)(B)),
      _c(f"{_name}_8_twice",
         lambda M, n=_name: getattr(M, n)(B, structure=st2, iterations=2),
         lambda n=_name: getattr(ndi, n)(B, structure=st2, iterations=2))]
CASES += [
    _c("binary_erosion_border", lambda M: M.binary_erosion(B, border_value=1),
       lambda: ndi.binary_erosion(B, border_value=1)),
    _c("binary_dilation_origin", lambda M: M.binary_dilation(B, origin=(0, 1)),
       lambda: ndi.binary_dilation(B, origin=(0, 1))),
    _c("binary_erosion_mask", lambda M: M.binary_erosion(B, mask=Mask),
       lambda: ndi.binary_erosion(B, mask=Mask)),
    _c("binary_dilation_to_stability",
       lambda M: M.binary_dilation(Seed, iterations=0, mask=Prop),
       lambda: ndi.binary_dilation(Seed, iterations=0, mask=Prop)),
    _c("binary_erosion_to_stability",
       lambda M: M.binary_erosion(Bl, iterations=0),
       lambda: ndi.binary_erosion(Bl, iterations=0)),
    _c("binary_dilation_3d", lambda M: M.binary_dilation(B3),
       lambda: ndi.binary_dilation(B3)),
    _c("binary_fill_holes_ring", lambda M: M.binary_fill_holes(Ring),
       lambda: ndi.binary_fill_holes(Ring)),
    _c("binary_fill_holes", lambda M: M.binary_fill_holes(B),
       lambda: ndi.binary_fill_holes(B)),
    _c("binary_fill_holes_3d", lambda M: M.binary_fill_holes(B3),
       lambda: ndi.binary_fill_holes(B3)),
    _c("binary_propagation", lambda M: M.binary_propagation(Seed, mask=Prop),
       lambda: ndi.binary_propagation(Seed, mask=Prop)),
    _c("binary_propagation_8",
       lambda M: M.binary_propagation(Seed, st2, mask=Prop),
       lambda: ndi.binary_propagation(Seed, st2, mask=Prop)),
    _c("binary_hit_or_miss", lambda M: M.binary_hit_or_miss(B, s1),
       lambda: ndi.binary_hit_or_miss(B, s1)),
    _c("generate_binary_structure",
       lambda M: M.generate_binary_structure(3, 2),
       lambda: ndi.generate_binary_structure(3, 2)),
    _c("iterate_structure",
       lambda M: M.iterate_structure(ndi.generate_binary_structure(2, 1), 2),
       lambda: ndi.iterate_structure(ndi.generate_binary_structure(2, 1),
                                     2)),
    _c("label", lambda M: M.label(Bl), lambda: ndi.label(Bl)),
    _c("label_8", lambda M: M.label(Bl, st2), lambda: ndi.label(Bl, st2)),
    _c("label_3d", lambda M: M.label(B3), lambda: ndi.label(B3)),
    _c("label_1d", lambda M: M.label(x1 > 0), lambda: ndi.label(x1 > 0)),
]
for _name in ("sum_labels", "sum", "mean", "variance", "standard_deviation",
              "minimum", "maximum", "minimum_position", "maximum_position",
              "extrema", "center_of_mass"):
  CASES += [
      _c(f"{_name}_index", lambda M, n=_name: getattr(M, n)(V, lab, idx),
         lambda n=_name: getattr(ndi, n)(V, lab, idx)),
      _c(f"{_name}_scalar_index", lambda M, n=_name: getattr(M, n)(V, lab, 3),
         lambda n=_name: getattr(ndi, n)(V, lab, 3)),
      _c(f"{_name}_labels_no_index", lambda M, n=_name: getattr(M, n)(V, lab),
         lambda n=_name: getattr(ndi, n)(V, lab)),
      _c(f"{_name}_no_labels", lambda M, n=_name: getattr(M, n)(V),
         lambda n=_name: getattr(ndi, n)(V)),
      _c(f"{_name}_nan", lambda M, n=_name: getattr(M, n)(Vn, lab, [1, 2, 3]),
         lambda n=_name: getattr(ndi, n)(Vn, lab, [1, 2, 3]))]
CASES += [
    _c("median_labels", lambda M: M.median(V, lab, [1, 2, 3]),
       lambda: ndi.median(V, lab, [1, 2, 3])),
    _c("histogram", lambda M: M.histogram(V, 0.0, 1.0, 5),
       lambda: ndi.histogram(V, 0.0, 1.0, 5)),
    _c("labeled_comprehension",
       lambda M: M.labeled_comprehension(V, lab, [1, 2, 3], np.ptp, float,
                                         0.0),
       lambda: ndi.labeled_comprehension(V, lab, [1, 2, 3], np.ptp, float,
                                         0.0)),
    _c("fourier_gaussian", lambda M: M.fourier_gaussian(Fc, 2.0),
       lambda: ndi.fourier_gaussian(Fc.copy(), 2.0)),
    _c("fourier_shift", lambda M: M.fourier_shift(Fc, (1.5, -2.0)),
       lambda: ndi.fourier_shift(Fc.copy(), (1.5, -2.0))),
    _c("fourier_uniform", lambda M: M.fourier_uniform(Fr, 3, n=A.shape[1]),
       lambda: ndi.fourier_uniform(Fr.copy(), 3, n=A.shape[1])),
    _c("fourier_ellipsoid", lambda M: M.fourier_ellipsoid(Fc, 3.0),
       lambda: ndi.fourier_ellipsoid(Fc.copy(), 3.0)),
    _c("fourier_gaussian_real", lambda M: M.fourier_gaussian(A, 1.0),
       lambda: ndi.fourier_gaussian(A.copy(), 1.0)),
]
for _order in (0, 1):
  for _mode, _theirs in (("constant", "constant"), ("nearest", "nearest"),
                         ("mirror", "mirror"), ("reflect", "reflect"),
                         ("wrap", "grid-wrap")):
    CASES.append(_c(
        f"map_coordinates_{_order}_{_mode}",
        lambda M, o=_order, m=_mode: M.map_coordinates(A, coords, order=o,
                                                       mode=m, cval=0.5),
        lambda o=_order, m=_theirs: ndi.map_coordinates(A, coords, order=o,
                                                        mode=m, cval=0.5)))
CASES += [
    _c("map_coordinates_halves_order0",
       lambda M: M.map_coordinates(A, halves, order=0),
       lambda: np.asarray(RN.map_coordinates(A, halves, order=0).glom())),
    _c("map_coordinates_1d", lambda M: M.map_coordinates(x1, coords1, order=1),
       lambda: ndi.map_coordinates(x1, coords1, order=1)),
    _c("map_coordinates_3d",
       lambda M: M.map_coordinates(A3, coords3, order=1, mode="nearest"),
       lambda: ndi.map_coordinates(A3, coords3, order=1, mode="nearest")),
    _c("map_coordinates_order3",
       lambda M: M.map_coordinates(A, coords, order=3),
       lambda: ndi.map_coordinates(A, coords, order=3)),
    _c("shift_order1", lambda M: M.shift(A, (1.0, -2.0), order=1),
       lambda: ndi.shift(A, (1.0, -2.0), order=1)),
    _c("shift_order0", lambda M: M.shift(A, (0.25, -1.75), order=0,
                                         mode="nearest"),
       lambda: ndi.shift(A, (0.25, -1.75), order=0, mode="nearest")),
    _c("shift_spline", lambda M: M.shift(A, 0.3), lambda: ndi.shift(A, 0.3)),
    _c("affine_transform",
       lambda M: M.affine_transform(A, Aff, offset=(0.5, -0.25), order=1),
       lambda: ndi.affine_transform(A, Aff, offset=(0.5, -0.25), order=1)),
    _c("affine_transform_homogeneous",
       lambda M: M.affine_transform(A, Hom, order=1, mode="reflect",
                                    output_shape=(10, 16)),
       lambda: ndi.affine_transform(A, Hom, order=1, mode="reflect",
                                    output_shape=(10, 16))),
    _c("rotate_reshape", lambda M: M.rotate(Rot, 30.0, order=1),
       lambda: ndi.rotate(Rot, 30.0, order=1)),
    _c("rotate_reshape_shapes_agree", lambda M: M.rotate(A, 30.0, order=1),
       lambda: ndi.rotate(A, 30.0, order=1)),
    _c("rotate_same_shape",
       lambda M: M.rotate(A, -17.0, order=1, reshape=False),
       lambda: ndi.rotate(A, -17.0, order=1, reshape=False)),
    _c("rotate_90", lambda M: M.rotate(A, 90.0, order=1),
       lambda: ndi.rotate(A, 90.0, order=1)),
    _c("zoom_up", lambda M: M.zoom(A, 1.5, order=1),
       lambda: ndi.zoom(A, 1.5, order=1)),
    _c("zoom_down_order0", lambda M: M.zoom(A, 0.6, order=0),
       lambda: ndi.zoom(A, 0.6, order=0)),
    _c("zoom_3d", lambda M: M.zoom(A3, (1.4, 0.8, 1.0), order=1),
       lambda: ndi.zoom(A3, (1.4, 0.8, 1.0), order=1)),
    _c("geometric_transform",
       lambda M: M.geometric_transform(A, lambda c: (c[0] * 0.9, c[1] + 0.3),
                                       order=1),
       lambda: ndi.geometric_transform(A, lambda c: (c[0] * 0.9,
                                                     c[1] + 0.3), order=1)),
    _c("spline_filter", lambda M: M.spline_filter(A),
       lambda: ndi.spline_filter(A)),
    _c("spline_filter1d", lambda M: M.spline_filter1d(A, axis=0),
       lambda: ndi.spline_filter1d(A, axis=0)),
    _c("distance_transform_edt", lambda M: M.distance_transform_edt(B),
       lambda: ndi.distance_transform_edt(B)),
    _c("distance_transform_cdt", lambda M: M.distance_transform_cdt(B),
       lambda: ndi.distance_transform_cdt(B)),
    _c("distance_transform_bf", lambda M: M.distance_transform_bf(B),
       lambda: ndi.distance_transform_bf(B)),
    _c("watershed_ift",
       lambda M: M.watershed_ift((A * 10 + 50).astype(np.uint8),
                                 lab[:12, :14].astype(np.int16)),
       lambda: ndi.watershed_ift((A * 10 + 50).astype(np.uint8),
                                 lab[:12, :14].astype(np.int16))),
    _c("generic_filter", lambda M: M.generic_filter(A, np.ptp, size=3),
       lambda: ndi.generic_filter(A, np.ptp, size=3)),
    _c("generic_filter1d",
       lambda M: M.generic_filter1d(
           A, lambda i, o: o.__setitem__(slice(None), i[:-2] + i[2:]), 3),
       lambda: ndi.generic_filter1d(
           A, lambda i, o: o.__setitem__(slice(None), i[:-2] + i[2:]), 3)),
]


def _assert_close(got, want, rtol, atol, what):
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                             equal_nan=True, err_msg=what)


def _close(got, want, rtol, atol) -> bool:
  return got.shape == want.shape and np.allclose(
      got, want, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("call,want,rtol,atol,defect,scipy_differs", CASES)
def test_function_against_scipy_and_the_reference(call, want, rtol, atol,
                                                  defect, scipy_differs):
  import warnings
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    got = g(call(N))
    scipy_value = g(want())
    if defect is None:
      theirs = g(call(RN))
      _assert_close(got, theirs, rtol, atol, "the reference")
    elif defect == "differs":
      assert not _close(g(call(RN)), scipy_value, rtol, atol)
    else:
      with pytest.raises(defect):
        g(call(RN))
  if scipy_differs:
    assert not _close(got, scipy_value, rtol, atol)
    return
  _assert_close(got, scipy_value, rtol, atol, "scipy")


def test_every_exported_function_has_a_case():
  """Each of ``sp.ndimage.__all__`` appears in a case's label."""
  labels = " ".join(p.id for p in CASES)
  missing = [n for n in N.__all__ if n not in labels
             and n not in ("find_objects", "value_indices")]
  assert missing == []


def test_find_objects_and_value_indices_are_scipys_on_the_host():
  before = fio.counts["host_runs"]
  assert N.find_objects(lab) == ndi.find_objects(lab)
  theirs = ndi.value_indices(lab, ignore_value=0)
  ours = N.value_indices(lab, ignore_value=0)
  assert ours.keys() == theirs.keys()
  for k in ours:
    for a, b in zip(ours[k], theirs[k]):
      np.testing.assert_array_equal(a, b)
  assert fio.counts["host_runs"] - before == 2


HOST_CALLS = [
    ("median", lambda: N.median(V, lab, [1, 2])),
    ("histogram", lambda: N.histogram(V, 0.0, 1.0, 4, lab, [1, 2])),
    ("labeled_comprehension",
     lambda: N.labeled_comprehension(V, lab, [1], np.mean, float, 0.0)),
    ("find_objects", lambda: N.find_objects(lab)),
    ("value_indices", lambda: N.value_indices(lab)),
    ("iterate_structure", lambda: N.iterate_structure(s1, 2)),
    ("map_coordinates_order2", lambda: N.map_coordinates(A, coords, order=2)),
    ("map_coordinates_grid_mode",
     lambda: N.map_coordinates(A, coords, order=1, mode="grid-constant")),
    ("shift_spline", lambda: N.shift(A, 0.3)),
    ("zoom_grid_mode", lambda: N.zoom(A, 1.5, order=1, grid_mode=True)),
    ("rotate_3d", lambda: N.rotate(A3, 10.0, order=1)),
    ("affine_order3", lambda: N.affine_transform(A, Aff)),
    ("geometric_transform",
     lambda: N.geometric_transform(A, lambda c: c, order=1)),
    ("spline_filter", lambda: N.spline_filter(A)),
    ("spline_filter1d", lambda: N.spline_filter1d(A)),
    ("distance_transform_edt", lambda: N.distance_transform_edt(B)),
    ("distance_transform_cdt", lambda: N.distance_transform_cdt(B)),
    ("distance_transform_bf", lambda: N.distance_transform_bf(B)),
    ("watershed_ift", lambda: N.watershed_ift(
        (A * 10 + 50).astype(np.uint8), lab[:12, :14].astype(np.int16))),
    ("generic_filter", lambda: N.generic_filter(A, np.ptp, size=3)),
    ("generic_filter1d", lambda: N.generic_filter1d(
        A, lambda i, o: o.__setitem__(slice(None), i[:-2]), 3)),
]


@pytest.mark.parametrize("name,call", HOST_CALLS,
                         ids=[n for n, _ in HOST_CALLS])
def test_each_host_boundary_counts_one_host_run(name, call):
  before = fio.counts["host_runs"]
  call()
  assert fio.counts["host_runs"] - before == 1, name


DEVICE_CALLS = [
    lambda: N.correlate(A, w33), lambda: N.median_filter(A, 3),
    lambda: N.binary_fill_holes(B), lambda: N.label(Bl),
    lambda: N.sum_labels(V, lab, idx), lambda: N.center_of_mass(V, lab),
    lambda: N.map_coordinates(A, coords, order=1),
    lambda: N.rotate(A, 30.0, order=1), lambda: N.zoom(A, 1.5, order=0),
    lambda: N.fourier_gaussian(Fc, 2.0),
    lambda: N.generate_binary_structure(2, 1),
]


@pytest.mark.parametrize("call", DEVICE_CALLS)
def test_the_device_functions_count_no_host_run(call):
  before = fio.counts["host_runs"]
  out = call()
  g(out)
  assert fio.counts["host_runs"] == before


@pytest.mark.parametrize("make", [
    lambda X: N.correlate(X, w33), lambda X: N.gaussian_filter(X, 1.0),
    lambda X: N.median_filter(X, 3), lambda X: N.minimum_filter(X, 3),
    lambda X: N.grey_opening(X, size=3), lambda X: N.laplace(X),
    lambda X: N.binary_erosion(X > 0), lambda X: N.binary_fill_holes(X > 0),
    lambda X: N.zoom(X, 1.5, order=1), lambda X: N.shift(X, 0.5, order=1),
    lambda X: N.map_coordinates(X, coords, order=1),
])
def test_filters_are_lazy_structural_maps(make):
  out = make(A)
  assert isinstance(out, Expr)
  maps = []
  out.visit(lambda n: maps.append(n) if isinstance(n, MapExpr) else None)
  assert any(is_structural(m.op) for m in maps)


def test_integer_images_filter_in_float64():
  """Integer and bool images filter in float64 (NumPy's result_type(dtype,
  float32)); scipy keeps the integer dtype and truncates, the reference
  gives float32.  The float64 values are scipy's before its cast."""
  Ai = rng.integers(0, 10, (12, 14)).astype(np.int32)
  for make, theirs in (
      (lambda M, X: M.correlate(X, w33), lambda X: ndi.correlate(X, w33)),
      (lambda M, X: M.gaussian_filter(X, 1.0),
       lambda X: ndi.gaussian_filter(X, 1.0)),
      (lambda M, X: M.median_filter(X, 3), lambda X: ndi.median_filter(X, 3)),
      (lambda M, X: M.uniform_filter(X, 3), lambda X: ndi.uniform_filter(X, 3))):
    got = g(make(N, Ai))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, theirs(Ai.astype(np.float64)),
                               rtol=1e-12, atol=1e-12)
    assert theirs(Ai).dtype == np.int32
    assert g(make(RN, Ai)).dtype == np.float32
  assert g(N.correlate(Ai > 4, w33)).dtype == np.float64


def test_float32_stays_float32():
  A32 = A.astype(np.float32)
  for make in (lambda M: M.correlate(A32, w33),
               lambda M: M.gaussian_filter(A32, 1.5),
               lambda M: M.median_filter(A32, 3),
               lambda M: M.map_coordinates(A32, coords, order=1),
               lambda M: M.zoom(A32, 1.5, order=1)):
    got = g(make(N))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, g(make(RN)), rtol=0, atol=2e-6)
  V32 = V.astype(np.float32)
  sums = N.sum_labels(V32, lab, idx)
  assert sums.dtype == np.float32
  # float64 segment sums rounded once: within an ulp of scipy's float64
  np.testing.assert_allclose(sums, ndi.sum_labels(V32.astype(np.float64),
                                                  lab, idx), rtol=6e-8)


def test_order0_rounds_half_away_from_zero():
  """jax.scipy.ndimage's order 0 rounds a coordinate at exactly .5 away
  from zero (torch.round would round it to even)."""
  x = np.arange(20.0).reshape(4, 5)
  c = np.array([[0.5, 1.5, 2.5, 0.0, -0.5], [0.0, 0.0, 0.0, 2.5, 0.0]])
  got = g(N.map_coordinates(x, c, order=0, mode="nearest"))
  np.testing.assert_array_equal(got, [5.0, 10.0, 15.0, 3.0, 0.0])
  np.testing.assert_array_equal(
      got, np.asarray(RN.map_coordinates(x, c, order=0,
                                         mode="nearest").glom()))


def test_loops_read_the_host_once_every_check_every_rounds():
  before = dict(nd_mod.counts)
  got = N.binary_fill_holes(B)
  g(got)
  rounds = nd_mod.counts["flood_rounds"] - before["flood_rounds"]
  reads = nd_mod.counts["reads"] - before["reads"]
  assert rounds == reads * nd_mod.CHECK_EVERY and reads >= 1
  before = dict(nd_mod.counts)
  N.label(Bl)
  rounds = nd_mod.counts["label_rounds"] - before["label_rounds"]
  reads = nd_mod.counts["reads"] - before["reads"]
  assert rounds == reads * nd_mod.CHECK_EVERY and reads >= 1


def test_label_numbers_components_in_raster_order_of_their_first_pixel():
  snake = np.zeros((9, 9), bool)
  snake[0, :] = snake[:, 8] = snake[8, :] = True  # one U-shaped component
  snake[2:7, 2] = True                            # and a bar inside it
  snake[4, 4:7] = True
  got, n = N.label(snake)
  want, m = ndi.label(snake)
  assert n == m == 3
  np.testing.assert_array_equal(got, want)
  assert got.dtype == np.int32


def test_sum_labels_of_a_float32_image_plans_onto_k1():
  K.reset_counts()
  V32 = V.astype(np.float32)
  got = N.sum_labels(V32)
  assert K.counts["plain_runs"] >= 1
  assert abs(got - float(V32.astype(np.float64).sum())) < 1e-3


def _largest_tensor(fn):
  """The most elements of any tensor an operation made while ``fn`` ran."""
  from torch.utils._python_dispatch import TorchDispatchMode
  seen = [0]

  class Watch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      for t in (out if isinstance(out, (tuple, list)) else [out]):
        if isinstance(t, torch.Tensor):
          seen[0] = max(seen[0], t.numel())
      return out
  with Watch():
    fn()
  return seen[0]


def test_measurements_build_nothing_of_labels_times_pixels():
  """With as many labels as a 60 x 70 image holds (every other pixel its
  own label), no tensor of a measurement grows past a few times the pixels:
  the reference's one-hot would hold labels x pixels."""
  img = rng.random((60, 70))
  labels = np.zeros((60, 70), np.int64)
  labels[::2, ::2] = np.arange(1, 30 * 35 + 1).reshape(30, 35)
  index = np.arange(1, 30 * 35 + 1)
  pixels = img.size
  for fn in (lambda: N.sum_labels(img, labels, index),
             lambda: N.variance(img, labels, index),
             lambda: N.extrema(img, labels, index),
             lambda: N.center_of_mass(img, labels, index)):
    assert _largest_tensor(fn) <= 4 * pixels
  np.testing.assert_allclose(N.center_of_mass(img, labels, index),
                             ndi.center_of_mass(img, labels, index),
                             rtol=1e-12)
  assert len(index) * pixels > 100 * 4 * pixels


def test_the_namespace_is_the_references():
  assert sp.ndimage is nd_mod
  assert sorted(N.__all__) == sorted(RN.__all__)
  assert len(N.__all__) == 75
  for name in N.__all__:
    assert callable(getattr(N, name)), name
