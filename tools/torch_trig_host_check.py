"""Host check of K1's sin, cos and tan (``csrc/trig_f.cuh``) against the
host's long-double libm, over every float exponent (no GPU needed).

    python3 tools/torch_trig_host_check.py [--samples 40000000]

Compiles ``trig_f.cuh`` for the host with g++ (the CUDA qualifiers defined
away, ``__float_as_uint`` by ``memcpy``) into a temporary directory, draws
random float bit patterns (every fourth with |x| below 2^32, where the
double-precision reduction runs), and prints for each function the worst
distance in ulps from ``(float)sinl(x)`` (``cosl``, ``tanl``), how many
results differ from it, and a few special values (signed zeros, 1e30,
the largest float, the edges of the two reductions).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HEADER = (Path(__file__).resolve().parents[1] / "spartan_tpu_torch" / "csrc"
          / "trig_f.cuh")

SOURCE = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
using std::isfinite;
#define __device__
#define __forceinline__ inline
#define __constant__
static inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
#include "trig_f.cuh"
static long ulps(float a, float b) {
  if (std::isnan(a) && std::isnan(b)) return 0;
  int32_t ia, ib;
  memcpy(&ia, &a, 4);
  memcpy(&ib, &b, 4);
  if (ia < 0) ia = INT32_MIN - ia;
  if (ib < 0) ib = INT32_MIN - ib;
  return labs((long)ia - (long)ib);
}
int main(int argc, char** argv) {
  const long samples = atol(argv[1]);
  std::mt19937_64 g(1);
  const char* names[3] = {"sin", "cos", "tan"};
  long worst[3] = {0, 0, 0}, off[3] = {0, 0, 0}, n = 0;
  float at[3] = {0, 0, 0};
  for (long i = 0; i < samples; ++i) {
    uint32_t u = (uint32_t)g();
    if (i % 4 == 0) u = (u & 0x807fffffu) | ((uint32_t)(100 + g() % 59) << 23);
    float x;
    memcpy(&x, &u, 4);
    if (!std::isfinite(x)) continue;
    const long double xl = x;
    const float want[3] = {(float)sinl(xl), (float)cosl(xl), (float)tanl(xl)};
    for (int w = 0; w < 3; ++w) {
      const long d = ulps(sp_trig::trig(w, x), want[w]);
      if (d > 0) ++off[w];
      if (d > worst[w]) { worst[w] = d; at[w] = x; }
    }
    ++n;
  }
  for (int w = 0; w < 3; ++w)
    printf("%s: worst %ld ulp (at %.9g); %ld of %ld results differ from "
           "(float)%sl\n", names[w], worst[w], at[w], off[w], n, names[w]);
  const float special[] = {0.0f, -0.0f, 1e-45f, 1.5707964f, 105615.0f,
                           1e6f, 33554430.0f, 33554432.0f, 1e30f, -1e30f,
                           3.4028235e38f};
  for (float x : special)
    for (int w = 0; w < 3; ++w) {
      const long double xl = x;
      const float want = w == 0 ? sinl(xl) : w == 1 ? cosl(xl) : tanl(xl);
      const float got = sp_trig::trig(w, x);
      printf("  %s(%.9g) = %.9g, (float)%sl %.9g, %ld ulp%s\n", names[w], x,
             got, names[w], want, ulps(got, want),
             std::signbit(got) != std::signbit(want) ? ", SIGN DIFFERS" : "");
    }
  return 0;
}
"""


def main() -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument("--samples", type=int, default=40_000_000)
  args = parser.parse_args()
  cxx = shutil.which("g++")
  if cxx is None:
    print("needs g++")
    return 1
  with tempfile.TemporaryDirectory() as tmp:
    src = Path(tmp) / "trig_check.cc"
    src.write_text(SOURCE)
    exe = Path(tmp) / "trig_check"
    subprocess.run([cxx, "-O2", "-std=c++17", f"-I{HEADER.parent}",
                    "-o", str(exe), str(src)], check=True)
    subprocess.run([str(exe), str(args.samples)], check=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
