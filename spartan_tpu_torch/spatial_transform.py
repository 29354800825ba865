"""``sp.spatial.transform`` — the scipy.spatial.transform surface (port of
``spartan_tpu/spatial_transform.py``).

``Rotation`` holds an ``(N, 4)`` scalar-last quaternion as a lazy expr on
the device; every conversion (matrix, rotation vector, Euler angles in the
24 conventions with the gimbal-lock branch selected elementwise, MRP),
composition, inversion, ``apply``, ``__pow__``, ``mean`` (the top
eigenvector of the weighted quaternion moment, ``torch.linalg.eigh``) and
``align_vectors`` (Kabsch, ``torch.linalg.svd``) is a ``map.structural``
function in torch ops, with no control flow a rotation.  ``Slerp`` finds
each time's interval by ``searchsorted`` and scales the relative rotation
vector.

``Rotation.random`` draws from a ``torch.Generator`` on the mesh's device
seeded from ``rng`` (its stream is not NumPy's).  ``create_group``,
``from_davenport``/``as_davenport``, ``reduce`` and ``align_vectors`` with
``return_sensitivity`` call scipy on the host, counted in
``expr.fio.counts["host_runs"]``; ``RotationSpline`` and ``RigidTransform``
are scipy's classes, re-exported.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import RigidTransform  # noqa: F401
from scipy.spatial.transform import RotationSpline  # noqa: F401

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.special import _f, _host_value, _mapn_whole

__all__ = ["Rotation", "Slerp", "RotationSpline", "RigidTransform"]

_HOST_NAMES = ["RigidTransform", "RotationSpline"]


def _scipy_rotation():
  fio.counts["host_runs"] += 1
  from scipy.spatial.transform import Rotation as _R
  return _R


# ---------------------------------------------------------------------
# quaternion kernels (torch tensors, (..., 4) scalar-last)
# ---------------------------------------------------------------------

def _quat_mul(p, q):
  px, py, pz, pw = p.unbind(-1)
  qx, qy, qz, qw = q.unbind(-1)
  return torch.stack([
      pw * qx + px * qw + py * qz - pz * qy,
      pw * qy - px * qz + py * qw + pz * qx,
      pw * qz + px * qy - py * qx + pz * qw,
      pw * qw - px * qx - py * qy - pz * qz], -1)


def _quat_norm(q):
  return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _quat_canonical(q):
  """The sign with w >= 0 (ties toward +x, +y, +z, as scipy)."""
  x, y, z, w = q.unbind(-1)
  neg = (w < 0) | ((w == 0) & ((x < 0) | ((x == 0) & ((y < 0) | (
      (y == 0) & (z < 0))))))
  return torch.where(neg[..., None], -q, q)


def _quat_to_matrix(q):
  x, y, z, w = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  rows = [
      torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
      torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
      torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
  ]
  return torch.stack(rows, -2)


def _matrix_to_quat(M):
  """Shepperd's method without branches: the four candidate quaternions,
  the one of the largest trace combination taken."""
  def m(i, j):
    return M[..., i, j]
  tr = m(0, 0) + m(1, 1) + m(2, 2)
  tw = 1.0 + tr
  tx = 1.0 + m(0, 0) - m(1, 1) - m(2, 2)
  ty = 1.0 - m(0, 0) + m(1, 1) - m(2, 2)
  tz = 1.0 - m(0, 0) - m(1, 1) + m(2, 2)
  qw = torch.stack([m(2, 1) - m(1, 2), m(0, 2) - m(2, 0),
                    m(1, 0) - m(0, 1), tw], -1)
  qx = torch.stack([tx, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0),
                    m(2, 1) - m(1, 2)], -1)
  qy = torch.stack([m(0, 1) + m(1, 0), ty, m(1, 2) + m(2, 1),
                    m(0, 2) - m(2, 0)], -1)
  qz = torch.stack([m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), tz,
                    m(1, 0) - m(0, 1)], -1)
  case = torch.argmax(torch.stack([tx, ty, tz, tw], -1), -1)[..., None]
  q = torch.where(case == 0, qx, torch.where(
      case == 1, qy, torch.where(case == 2, qz, qw)))
  return _quat_norm(q)


def _scalar_like(v, x):
  return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _quat_from_rotvec(v):
  t2 = (v * v).sum(-1)
  t = torch.sqrt(t2)
  small = t < 1e-3
  one = _scalar_like(1.0, t)
  # sin(t/2)/t, a Taylor series for tiny angles
  scale = torch.where(small, 0.5 - t2 / 48.0 + t2 * t2 / 3840.0,
                      torch.sin(torch.where(small, one, t) / 2)
                      / torch.where(small, one, t))
  w = torch.cos(t / 2)
  return torch.cat([v * scale[..., None], w[..., None]], -1)


def _quat_to_rotvec(q):
  q = _quat_canonical(q)
  s = torch.linalg.vector_norm(q[..., :3], dim=-1)
  angle = 2.0 * torch.atan2(s, q[..., 3])
  small = angle < 1e-3
  a2 = angle * angle
  one = _scalar_like(1.0, angle)
  # angle / sin(angle/2), a Taylor series for tiny angles
  scale = torch.where(small, 2.0 + a2 / 12.0 + 7.0 * a2 * a2 / 2880.0,
                      angle / torch.sin(torch.where(small, one, angle) / 2))
  return q[..., :3] * scale[..., None]


def _quat_inv(q):
  return torch.cat([-q[..., :3], q[..., 3:]], -1)


def _cross(u, v):
  u, v = torch.broadcast_tensors(u, v)
  return torch.linalg.cross(u, v, dim=-1)


def _apply_quat(q, v, inverse=False):
  """Rotate ``(..., 3)`` vectors: v + 2w (u × v) + 2 u × (u × v)."""
  u = -q[..., :3] if inverse else q[..., :3]
  w = q[..., 3:]
  uv = _cross(u, v)
  return v + 2.0 * (w * uv + _cross(u, uv))


_AXES = {"x": 0, "y": 1, "z": 2}


def _elem_quat(axis, angle):
  """Angles ``(...,)`` about one axis -> quaternions ``(..., 4)``."""
  half = angle / 2
  zero = torch.zeros_like(half)
  parts = [zero, zero, zero]
  parts[axis] = torch.sin(half)
  parts.append(torch.cos(half))
  return torch.stack(parts, -1)


def _euler_to_quat(axes, intrinsic, angles):
  """Intrinsic sequences compose left to right (the body frame),
  extrinsic right to left (scipy's)."""
  q = _elem_quat(axes[0], angles[..., 0])
  for i, ax in enumerate(axes[1:], start=1):
    e = _elem_quat(ax, angles[..., i])
    q = _quat_mul(q, e) if intrinsic else _quat_mul(e, q)
  return q


def _quat_to_euler(q, axes, intrinsic, degrees):
  """The 24 conventions from the rotation matrix (the index and parity
  form), the gimbal-lock branch selected elementwise with the third angle
  0, as scipy."""
  if not intrinsic:
    return _quat_to_euler(q, axes[::-1], True, degrees).flip(-1)
  M = _quat_to_matrix(q)

  def m(a, b):
    return M[..., a, b]
  i, j, k = axes
  eps = 1e-7
  zero = torch.zeros_like(m(0, 0))
  if i == k:   # proper Euler (ZXZ, ...)
    l_ = 3 - i - j
    s = 1.0 if (i, j, l_) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0
    cb = torch.clamp(m(i, i), -1.0, 1.0)
    b = torch.arccos(cb)
    a = torch.atan2(m(j, i), -s * m(l_, i))
    c = torch.atan2(m(i, j), s * m(i, l_))
    lock = torch.abs(cb) > 1.0 - eps
    a_lock = torch.atan2(-torch.sign(cb) * s * m(j, l_), m(j, j))
  else:        # Tait-Bryan (XYZ, ...)
    s = 1.0 if (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1)) else -1.0
    sb = torch.clamp(s * m(i, k), -1.0, 1.0)
    b = torch.arcsin(sb)
    a = torch.atan2(-s * m(j, k), m(k, k))
    c = torch.atan2(-s * m(i, j), m(i, i))
    lock = torch.abs(sb) > 1.0 - eps
    a_lock = torch.atan2(torch.sign(sb) * m(j, i), m(j, j))
  a = torch.where(lock, a_lock, a)
  c = torch.where(lock, zero, c)
  out = torch.stack([a, b, c], -1)
  return torch.rad2deg(out) if degrees else out


def _parse_seq(seq):
  if not 1 <= len(seq) <= 3:
    raise ValueError(f"expected 1-3 axes, got {seq!r}")
  intrinsic = seq.isupper()
  if not intrinsic and not seq.islower():
    raise ValueError(f"cannot mix intrinsic/extrinsic axes in {seq!r}")
  axes = [_AXES[c] for c in seq.lower()]
  if any(a == b for a, b in zip(axes, axes[1:])):
    raise ValueError(f"consecutive axes must differ in {seq!r}")
  return axes, intrinsic


def _batched(e, nd_single):
  """``e`` with a leading batch axis when it has ``nd_single`` axes."""
  e = sp.lazify(e)
  if len(e.shape) == nd_single:
    return _mapn_whole(lambda a: a[None], e), True
  return e, False


class Rotation:
  """Batched 3-D rotations as a lazy scalar-last quaternion expr."""

  def __init__(self, quat, normalize=True, copy=True):
    q = sp.lazify(quat)
    if len(q.shape) == 1:
      if tuple(q.shape) != (4,):
        raise ValueError(f"quaternion shape {q.shape}, expected (4,)")
      self._single = True
      q = _mapn_whole(lambda a: a[None, :], q)
    else:
      if len(q.shape) != 2 or q.shape[1] != 4:
        raise ValueError(f"quaternion shape {q.shape}, expected (N, 4)")
      self._single = False
    if normalize:
      q = _mapn_whole(lambda a: _quat_norm(_f(a)), q)
    self._quat = q

  @classmethod
  def _of(cls, q, single):
    out = cls(q, normalize=False)
    out._single = single
    return out

  # -- construction ----------------------------------------------------

  @classmethod
  def from_quat(cls, quat, *, scalar_first=False):
    if scalar_first:
      q = _mapn_whole(lambda a: torch.cat([a[..., 1:], a[..., :1]], -1),
                      quat)
      return cls(q)
    return cls(quat)

  @classmethod
  def from_matrix(cls, matrix):
    M, single = _batched(matrix, 2)
    return cls._of(_mapn_whole(lambda a: _matrix_to_quat(_f(a)), M),
                   single)

  @classmethod
  def from_rotvec(cls, rotvec, degrees=False):
    v, single = _batched(rotvec, 1)

    def kern(a):
      a = _f(a)
      return _quat_from_rotvec(torch.deg2rad(a) if degrees else a)
    return cls._of(_mapn_whole(kern, v), single)

  @classmethod
  def from_euler(cls, seq, angles, degrees=False):
    axes, intrinsic = _parse_seq(seq)
    a = sp.lazify(angles)
    shp = tuple(a.shape)
    # scipy's shapes: () (a 1-axis sequence) or (L,) is one rotation;
    # (N, L) a batch, L the sequence's length
    if shp == () and len(axes) == 1:
      single = True
    elif len(shp) in (1, 2) and shp[-1] == len(axes):
      single = len(shp) == 1
    else:
      raise ValueError(f"angles shape {shp} does not match "
                       f"{len(axes)}-axis seq {seq!r}")

    def kern(ang):
      ang = _f(ang)
      ang = torch.deg2rad(ang) if degrees else ang
      ang = torch.atleast_1d(ang)
      if ang.ndim == 1:
        ang = ang[None]
      return _euler_to_quat(axes, intrinsic, ang)
    return cls._of(_mapn_whole(kern, a), single)

  @classmethod
  def from_mrp(cls, mrp):
    p, single = _batched(mrp, 1)

    def kern(a):
      a = _f(a)
      n2 = (a * a).sum(-1, keepdim=True)
      return torch.cat([2 * a / (1 + n2), (1 - n2) / (1 + n2)], -1)
    return cls._of(_mapn_whole(kern, p), single)

  @classmethod
  def identity(cls, num=None):
    q = np.zeros((1 if num is None else num, 4))
    q[:, 3] = 1.0
    return cls._of(q, num is None)

  @classmethod
  def random(cls, num=None, rng=None):
    """Uniform on SO(3): normalized Gaussian quaternions drawn from a
    ``torch.Generator`` seeded from ``rng``."""
    if isinstance(rng, np.random.Generator):
      seed = int(rng.integers(0, 2 ** 63 - 1))
    elif rng is None:
      seed = int(np.random.default_rng().integers(0, 2 ** 63 - 1))
    else:
      seed = int(rng)
    device = sp.get_mesh().device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.randn((1 if num is None else num, 4), generator=gen,
                    dtype=torch.float64, device=device)
    out = cls(q)  # the constructor normalizes
    out._single = num is None
    return out

  @classmethod
  def concatenate(cls, rotations):
    q = _mapn_whole(lambda *a: torch.cat(a, 0), *[r._quat for r in rotations])
    return cls(q, normalize=False)

  @classmethod
  def align_vectors(cls, a, b, weights=None, return_sensitivity=False):
    """Kabsch on the device: the SVD of the weighted cross-covariance."""
    if return_sensitivity:
      ops = [np.asarray(_host_value(sp.lazify(x))) for x in (a, b)]
      w = None if weights is None else np.asarray(
          _host_value(sp.lazify(weights)))
      est, rssd, sens = _scipy_rotation().align_vectors(
          *ops, weights=w, return_sensitivity=True)
      return cls.from_quat(est.as_quat()), rssd, sens
    ops = [a, b] + ([] if weights is None else [weights])

    def kern(aa, bb, *w):
      aa, bb = torch.atleast_2d(_f(aa)), torch.atleast_2d(_f(bb))
      ww = _f(w[0]).to(aa.dtype) if w else torch.ones(
          aa.shape[0], dtype=aa.dtype, device=aa.device)
      Bm = (aa * ww[:, None]).T @ bb
      U, S, Vt = torch.linalg.svd(Bm)
      sgn = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
      U = torch.cat([U[:, :-1], U[:, -1:] * sgn], 1)
      C = U @ Vt
      ss = (ww[:, None] * (aa * aa + bb * bb)).sum()
      sv = torch.cat([S[:-1], S[-1:] * sgn])
      rssd = torch.sqrt(torch.clamp(ss - 2.0 * sv.sum(), min=0.0))
      return torch.cat([_matrix_to_quat(C[None]).reshape(-1),
                        rssd.reshape(1)])
    packed = _mapn_whole(kern, *ops)
    q = _mapn_whole(lambda v: v[None, :4], packed)
    rssd = _mapn_whole(lambda v: v[4], packed)
    return cls._of(q, True), rssd

  # -- host boundaries (tabular or sequential scipy) -------------------

  @classmethod
  def create_group(cls, group, axis="Z"):
    return cls.from_quat(_scipy_rotation().create_group(
        group, axis=axis).as_quat())

  @classmethod
  def from_davenport(cls, axes, order, angles, degrees=False):
    ax = np.asarray(_host_value(sp.lazify(axes)))
    ang = np.asarray(_host_value(sp.lazify(angles)))
    return cls.from_quat(_scipy_rotation().from_davenport(
        ax, order, ang, degrees=degrees).as_quat())

  def as_davenport(self, axes, order, degrees=False):
    return self._scipy().as_davenport(
        np.asarray(_host_value(sp.lazify(axes))), order, degrees=degrees)

  def reduce(self, left=None, right=None, return_indices=False):
    out = self._scipy().reduce(
        None if left is None else left._scipy(),
        None if right is None else right._scipy(),
        return_indices=return_indices)
    if return_indices:
      red, li, ri = out
      return Rotation.from_quat(red.as_quat()), li, ri
    return Rotation.from_quat(out.as_quat())

  def _scipy(self):
    return _scipy_rotation().from_quat(
        np.array(_host_value(sp.lazify(self.as_quat())), copy=True))

  # -- representations -------------------------------------------------

  def _sq(self, expr):
    """The batch axis squeezed off a single rotation's result."""
    if not self._single:
      return expr
    return _mapn_whole(lambda a: a[0], expr)

  def _out(self, fn):
    return self._sq(_mapn_whole(fn, self._quat))

  def as_quat(self, canonical=False, *, scalar_first=False):
    def kern(q):
      q = _quat_canonical(q) if canonical else q
      if scalar_first:
        q = torch.cat([q[..., 3:], q[..., :3]], -1)
      return q
    return self._out(kern)

  def as_matrix(self):
    return self._out(lambda q: _quat_to_matrix(_f(q)))

  def as_rotvec(self, degrees=False):
    def kern(q):
      v = _quat_to_rotvec(_f(q))
      return torch.rad2deg(v) if degrees else v
    return self._out(kern)

  def as_euler(self, seq, degrees=False):
    axes, intrinsic = _parse_seq(seq)
    if len(axes) != 3:
      raise ValueError("as_euler needs a 3-axis sequence")
    return self._out(lambda q: _quat_to_euler(_f(q), axes, intrinsic,
                                              degrees))

  def as_mrp(self):
    def kern(q):
      q = _quat_canonical(_f(q))
      return q[..., :3] / (1.0 + q[..., 3:])
    return self._out(kern)

  # -- algebra ---------------------------------------------------------

  def apply(self, vectors, inverse=False):
    v = sp.lazify(vectors)
    vec_single = len(v.shape) == 1

    def kern(q, vv):
      return _apply_quat(_f(q), torch.atleast_2d(_f(vv)), inverse=inverse)
    out = _mapn_whole(kern, self._quat, v)
    if self._single and vec_single:
      return _mapn_whole(lambda a: a[0], out)
    return out

  def __mul__(self, other):
    q = _mapn_whole(lambda p, r: _quat_norm(_quat_mul(_f(p), _f(r))),
                    self._quat, other._quat)
    return Rotation._of(q, self._single and other._single)

  def __pow__(self, n, modulus=None):
    if modulus is not None:
      raise NotImplementedError("modulus not supported")
    nn = float(n)
    q = _mapn_whole(lambda p: _quat_from_rotvec(nn * _quat_to_rotvec(_f(p))),
                    self._quat)
    return Rotation._of(q, self._single)

  def inv(self):
    return Rotation._of(_mapn_whole(_quat_inv, self._quat), self._single)

  def magnitude(self):
    def kern(q):
      q = _f(q)
      return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., :3], dim=-1),
                               torch.abs(q[..., 3]))
    return self._out(kern)

  def mean(self, weights=None):
    """The top eigenvector of the weighted moment ``sum w q qᵀ``."""
    ops = [self._quat] + ([] if weights is None else [weights])

    def kern(q, *w):
      q = _f(q)
      ww = _f(w[0]).to(q.dtype) if w else torch.ones(
          q.shape[0], dtype=q.dtype, device=q.device)
      K = (q * ww[:, None]).T @ q
      return torch.linalg.eigh(K)[1][:, -1][None]
    return Rotation._of(_mapn_whole(kern, *ops), True)

  def approx_equal(self, other, atol=None, degrees=False):
    tol = atol if atol is not None else (0.1 if degrees else 1e-8)
    if degrees and atol is not None:
      tol = float(np.radians(atol))
    return (self * other.inv()).magnitude() < tol

  # -- container protocol ----------------------------------------------

  def __len__(self):
    if self._single:
      raise TypeError("single rotation has no len()")
    return self._quat.shape[0]

  def __getitem__(self, idx):
    if self._single:
      raise TypeError("single rotation is not subscriptable")
    if isinstance(idx, (int, np.integer)):
      i = int(idx)
      return Rotation._of(_mapn_whole(lambda q: q[i][None], self._quat),
                          True)
    return Rotation._of(self._quat[idx], False)

  def __repr__(self):
    n = 1 if self._single else self._quat.shape[0]
    return f"Rotation({'single' if self._single else n}, lazy quat)"


class Slerp:
  """Spherical linear interpolation over key rotations: each time's
  interval by ``searchsorted``, the relative rotation vector scaled."""

  def __init__(self, times, rotations):
    if rotations._single or len(rotations) < 2:
      raise ValueError("Slerp needs >= 2 rotations")
    self.times = sp.lazify(times)
    if tuple(self.times.shape) != (len(rotations),):
      raise ValueError("times must match the number of rotations")
    self.rotations = rotations

  def __call__(self, times):
    t = sp.lazify(times)
    single = len(t.shape) == 0

    def kern(knots, quats, tq):
      knots, quats = _f(knots), _f(quats)
      tq = torch.atleast_1d(_f(tq)).to(knots.dtype)
      idx = torch.clamp(torch.searchsorted(knots, tq, right=True) - 1,
                        0, knots.shape[0] - 2)
      q0, q1 = quats[idx], quats[idx + 1]
      alpha = (tq - knots[idx]) / (knots[idx + 1] - knots[idx])
      rel = _quat_mul(_quat_inv(q0), q1)
      step = _quat_from_rotvec(alpha[:, None] * _quat_to_rotvec(rel))
      return _quat_mul(q0, step)
    q = _mapn_whole(kern, self.times, self.rotations._quat, t)
    return Rotation._of(q, single)
