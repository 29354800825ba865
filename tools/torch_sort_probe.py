"""How ``torch.sort(stable=True)`` orders ties, signed zeros and NaNs on the
card, against NumPy's stable argsort (card only, about 2 min).

    python3 tools/torch_sort_probe.py

For 1-D keys of 100 to 2^26 elements (int32 with heavy ties, float32 of
-1, -0.0, +0.0 and 1, float32 normals with NaN, the same with some NaNs'
sign bits set, float64 with NaN and signed zeros, uint8, bool) and for
2-D float32 keys along each axis, it prints whether the indices and the
values equal NumPy's, the count of mismatched indices and the first of
them.  Then ``torch.cummax``/``cummin`` over a NaN, ``torch.searchsorted``
of NaN, ``torch.cumsum`` of float32 to float64 and ``torch.bincount`` on
the card.  The port's sorts (``spartan_tpu_torch/expr/sort_expr.py``)
make every NaN the one quiet NaN before sorting because of what this
prints for NaNs with the sign bit set.
"""

import time

import numpy as np
import torch


def case(name, x, dim=-1, dev="cuda"):
  t = torch.from_numpy(x).to(dev)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  r = torch.sort(t, dim=dim, stable=True)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  idx = r.indices.cpu().numpy()
  vals = r.values.cpu().numpy()
  want = np.argsort(x, axis=dim, kind="stable")
  ok_i = np.array_equal(idx, want)
  wv = np.take_along_axis(x, want, dim)
  ok_v = (np.array_equal(vals, wv, equal_nan=True)
          and np.array_equal(np.signbit(vals), np.signbit(wv)))
  bad = np.nonzero((idx != want).ravel())[0]
  print(f"{name}: shape {x.shape} dim {dim} idx exact {ok_i} values exact "
        f"{ok_v} mismatches {bad.size} {ms:.1f} ms", flush=True)
  if bad.size:
    i = bad[0]
    print("   first", i, idx.ravel()[i:i + 4], want.ravel()[i:i + 4],
          x.ravel()[idx.ravel()[i:i + 4]] if x.ndim == 1 else "")


def main() -> None:
  print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        flush=True)
  dev = "cuda"
  rng = np.random.default_rng(0)
  for n in (100, 2000, 5000, 1 << 20, 1 << 26):
    case(f"int32 ties n={n}", rng.integers(0, 16, n).astype(np.int32))
    z = rng.choice(np.array([-1, -0.0, 0.0, 1], np.float32), n)
    case(f"f32 +-0 n={n}", z)
    f = rng.standard_normal(n).astype(np.float32)
    f[rng.random(n) < 0.05] = np.nan
    case(f"f32 nan n={n}", f)
    g = f.copy()
    g[rng.random(n) < 0.03] = -np.nan
    case(f"f32 -nan n={n}", g)
    h = rng.standard_normal(n)
    h[rng.random(n) < 0.05] = np.nan
    h[rng.random(n) < 0.05] = -0.0
    h[rng.random(n) < 0.05] = 0.0
    case(f"f64 nan/zeros n={n}", h)
    case(f"uint8 n={n}", rng.integers(0, 4, n).astype(np.uint8))
    case(f"bool n={n}", rng.random(n) < 0.5)
  for shape in ((16384, 2048), (2048, 16384), (64, 100000)):
    z = rng.choice(np.array([-1, -0.0, 0.0, 1, np.nan], np.float32), shape)
    case("2d zeros/nan", z, 1)
    case("2d zeros/nan", z, 0)
  x = torch.tensor([1., float("nan"), 3., -2., float("inf")], device=dev)
  print("cummax", torch.cummax(x, 0).values.tolist(), "cummin",
        torch.cummin(x, 0).values.tolist())
  y = torch.tensor([[1., 2.], [float("nan"), 0.]], device=dev)
  print("cummax 2d", torch.cummax(y, 0).values.tolist(),
        torch.cummin(y, 1).values.tolist())
  a = torch.tensor([1.0, 2.0, float("nan")], device=dev)
  q = torch.tensor([float("nan"), 5.0], device=dev)
  print("searchsorted", torch.searchsorted(a, q).tolist(),
        torch.searchsorted(a, q, right=True).tolist())
  c = torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32)).to(
      dev)
  s64 = torch.cumsum(c, 0, dtype=torch.float64)
  print("cumsum dtype", s64.dtype, float((s64.cpu() - torch.from_numpy(
      np.cumsum(c.cpu().numpy().astype(np.float64)))).abs().max()))
  print("bincount", torch.bincount(torch.tensor([0, 2, 2], device=dev),
                                   minlength=4).tolist())


if __name__ == "__main__":
  main()
