"""2-D stencil, convolution and pooling (port of
``spartan_tpu/expr/stencil.py``).

Layout NCHW (batch, channel, height, width), filters OIHW, as in the
reference.  ``StencilExpr`` is a cross-correlation (no filter flip):

* single-channel stride-1 filters of up to 49 taps under 'SAME' or
  'VALID' take the reference's shifted-add emission, tap by tap in the
  same row-major order, so float64 results agree to rounding;
* every other case runs ``torch.nn.functional.conv2d``, where the
  reference ran XLA's convolution (no Pallas kernel on either side).

Padding follows XLA's rule: per spatial dim the output has
``ceil(in / stride)`` cells under 'SAME', and the total pad
``max((out - 1) * stride + k - in, 0)`` is split with ``total // 2`` on
the low side, so it can be asymmetric.  ``F.conv2d(padding="same")``
refuses a stride above 1 and ``F.max_pool2d`` pads both sides alike, so
the pads are applied here with ``F.pad``: zeros for convolution and sums,
``-inf`` (the dtype's minimum for integers) for max pooling.  Average
pooling divides by the count of cells inside the image, as the
reference's ``reduce_window`` of ones does.  Only the padding strings
'SAME' and 'VALID' are taken.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.nn.functional as F

from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify


def _pair(v) -> Tuple[int, int]:
  if isinstance(v, (tuple, list)):
    return (int(v[0]), int(v[1]))
  return (int(v), int(v))


def _pads(padding: str, size: int, k: int, s: int) -> Tuple[int, int]:
  """(low, high) pad of one spatial dim under XLA's padding rule."""
  if padding == "VALID":
    return (0, 0)
  if padding == "SAME":
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return (total // 2, total - total // 2)
  raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _pad2d(x, padding: str, window, stride, value: float = 0.0):
  """``x`` (N, C, H, W) padded on H and W; returns it and the (low, high)
  pads."""
  (h0, h1), (w0, w1) = (_pads(padding, x.shape[2], window[0], stride[0]),
                        _pads(padding, x.shape[3], window[1], stride[1]))
  if h0 or h1 or w0 or w1:
    x = F.pad(x, (w0, w1, h0, h1), value=value)
  return x, ((h0, h1), (w0, w1))


def _windows(x, window, stride):
  """(N, C, OH, OW, kh, kw) view of the windows of a padded ``x``."""
  return x.unfold(2, window[0], stride[0]).unfold(3, window[1], stride[1])


class StencilExpr(Expr):
  """2-D convolution (cross-correlation) of NCHW images with OIHW filters."""

  _members = ("inputs",)
  _params = ("stride", "padding")

  def __init__(self, images, filters, stride=1, padding="SAME"):
    super().__init__(inputs=[lazify(images), lazify(filters)],
                     stride=_pair(stride), padding=padding)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x, w = deps
    acc = torch.promote_types(x.dtype, w.dtype)
    if (self.stride == (1, 1) and w.ndim == 4
        and w.shape[0] == 1 and w.shape[1] == 1
        and w.shape[2] * w.shape[3] <= 49
        and self.padding in ("SAME", "VALID")):
      return self._emit_shifted(x, w, acc)
    xp, _ = _pad2d(x.to(acc), self.padding, w.shape[2:], self.stride)
    return F.conv2d(xp, w.to(acc), stride=self.stride)

  def _emit_shifted(self, x, w, acc):
    kh, kw = int(w.shape[2]), int(w.shape[3])
    n, c, h, ww = x.shape
    xp, _ = _pad2d(x.to(acc), self.padding, (kh, kw), (1, 1))
    oh, ow = xp.shape[2] - kh + 1, xp.shape[3] - kw + 1
    out = torch.zeros((n, c, oh, ow), dtype=acc, device=x.device)
    for di in range(kh):
      for dj in range(kw):
        tap = w[0, 0, di, dj].to(acc)
        out = out + tap * xp[:, :, di:di + oh, dj:dj + ow]
    return out


def _valid_counts(size: int, k: int, s: int, low: int, out: int, device):
  """Cells of each window inside ``[0, size)`` along one dim."""
  starts = torch.arange(out, device=device) * s - low
  return (torch.clamp(starts + k, max=size) - torch.clamp(starts, min=0))


class PoolExpr(Expr):
  """Max/avg pooling over NCHW spatial dims."""

  _members = ("inputs",)
  _params = ("op", "pool", "stride", "padding")

  def __init__(self, images, pool_size=2, stride=None, op="max",
               padding="SAME"):
    pool = _pair(pool_size)
    stride = _pair(stride) if stride is not None else pool
    super().__init__(inputs=[lazify(images)], op=op, pool=pool,
                     stride=stride, padding=padding)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    if self.op not in ("max", "avg"):
      raise ValueError(self.op)
    # non-overlapping pools that divide the image: the reference's
    # reshape-fold formulation
    if (self.stride == self.pool and x.ndim == 4
        and x.shape[2] % self.pool[0] == 0
        and x.shape[3] % self.pool[1] == 0):
      n, c, h, w = x.shape
      ph, pw = self.pool
      folded = x.reshape(n, c, h // ph, ph, w // pw, pw)
      if self.op == "max":
        return folded.amax(dim=(3, 5))
      if not x.is_floating_point():
        folded = folded.to(torch.float64)  # NumPy's mean of integers
      return folded.mean(dim=(3, 5))
    if self.op == "max":
      init = (float("-inf") if x.is_floating_point()
              else torch.iinfo(x.dtype).min)
      xp, _ = _pad2d(x, self.padding, self.pool, self.stride, value=init)
      return _windows(xp, self.pool, self.stride).amax(dim=(-2, -1))
    xp, ((h0, _), (w0, _)) = _pad2d(x, self.padding, self.pool, self.stride)
    s = _windows(xp, self.pool, self.stride).sum(dim=(-2, -1))
    cnt = (_valid_counts(x.shape[2], self.pool[0], self.stride[0], h0,
                         s.shape[2], x.device)[:, None]
           * _valid_counts(x.shape[3], self.pool[1], self.stride[1], w0,
                           s.shape[3], x.device)[None, :])
    if not x.is_floating_point():
      s = s.to(torch.float64)  # true division of integer sums
    return s / cnt.to(s.dtype)


def stencil(images, filters, stride=1, padding="SAME") -> StencilExpr:
  return StencilExpr(images, filters, stride, padding)


def maxpool(images, pool_size=2, stride=None, padding="SAME") -> PoolExpr:
  return PoolExpr(images, pool_size, stride, "max", padding)


def avgpool(images, pool_size=2, stride=None, padding="SAME") -> PoolExpr:
  return PoolExpr(images, pool_size, stride, "avg", padding)
