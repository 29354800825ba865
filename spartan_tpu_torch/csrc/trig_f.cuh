// sin, cos and tan of a float, for the op program's rare ops
// (op_program.cuh).
//
// CUDA's sinf/cosf/tanf reduce an argument past 105615 by a Payne-Hanek
// reduction that keeps its words of x * 2/pi in a local array, a stack
// frame in every kernel that calls them (and the op-program kernels are
// held to none).  These keep every value in registers:
//  * |x| < 2^25: x = j pi/2 + r with j = rint(x 2/pi) and r from two fma
//    steps in double (pi/2 as a double and its remainder): each step
//    rounds once, so r is good to about 2^-53 of itself.
//  * |x| >= 2^25: Payne-Hanek.  |x| = m 2^k with m a 24-bit integer and k
//    >= 2; the bits of 2/pi whose weight times m is a multiple of 4 cannot
//    move the quadrant, so only the 96 bits from bit k - 1 on matter:
//    three words funnel-shifted from kTwoOverPi (a run-time index into
//    constant memory, no local array), m times them in 64-bit pieces, the
//    quadrant in the two bits above the binary point and 64 bits of
//    fraction (the tail left out is below 2^-70).
//  * sin and cos of r in double by their Taylor series (to r^11 and
//    r^12; |r| <= pi/4 leaves a relative error below 1e-11), rounded once
//    to float, so the results are within an ulp of the exact value, as
//    torch's sinf-based ones are (CUDA's bound: 2 ulp).

#pragma once

#include <stdint.h>

namespace sp_trig {

// 2/pi from its binary point on, 32 bits a word, most significant first:
// words 0 .. 6 cover every float exponent.
__constant__ uint32_t kTwoOverPi[8] = {
    0xA2F9836Eu, 0x4E441529u, 0xFC2757D1u, 0xF534DDC0u,
    0xDB629599u, 0x3C439041u, 0xFE5163ABu, 0xDEBBC561u};

// The 32 bits of hi:lo from bit 32 - s down (0 <= s < 32).
__device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (32 - s));
}

// x = q pi/2 + r for a finite x; returns r, |r| a little past pi/4 at most.
__device__ __forceinline__ double reduce(float x, int& q) {
  const double xd = (double)x;
  if (fabsf(x) < 33554432.0f) {  // 2^25
    const double j = rint(xd * 0x1.45f306dc9c883p-1);  // 2/pi
    q = (int)j;
    const double r = fma(-j, 0x1.921fb54442d18p+0, xd);  // pi/2
    return fma(-j, 0x1.1a62633145c07p-54, r);  // pi/2 - its double
  }
  const uint32_t u = __float_as_uint(x);
  const int k = (int)((u >> 23) & 255u) - 150;  // |x| = m 2^k, k >= 2
  const uint32_t m = (u & 0x7fffffu) | 0x800000u;
  const int j0 = (k - 2) >> 5, sh = (k - 2) & 31;
  const uint32_t w0 = kTwoOverPi[j0], w1 = kTwoOverPi[j0 + 1],
                 w2 = kTwoOverPi[j0 + 2], w3 = kTwoOverPi[j0 + 3];
  const uint64_t p0 = (uint64_t)m * funnel(w3, w2, sh);
  const uint64_t p1 = (uint64_t)m * funnel(w2, w1, sh) + (p0 >> 32);
  const uint64_t p2 = (uint64_t)m * funnel(w1, w0, sh) + (p1 >> 32);
  // the fraction's 64 bits; past one half it counts as the next quadrant's
  // negative remainder (its top bit as a sign)
  const uint64_t frac = (p2 << 34) | ((p1 & 0xffffffffull) << 2) |
                        ((p0 & 0xffffffffull) >> 30);
  q = (int)(((p2 >> 30) + (frac >> 63)) & 3u);
  const double r = (double)(int64_t)frac * 0x1.921fb54442d18p-64;
  if (x < 0.0f) {
    q = -q;
    return -r;
  }
  return r;
}

// sin (op 0), cos (1) or tan (2) of x.
__device__ __forceinline__ float trig(int which, float x) {
  if (!isfinite(x)) return x - x;  // nan
  if (x == 0.0f) return which == 1 ? 1.0f : x;  // keeps -0.0
  int q;
  const double r = reduce(x, q);
  const double r2 = r * r;
  const double s =
      r + r * r2 * (-1.0 / 6 + r2 * (1.0 / 120 + r2 * (-1.0 / 5040 +
                    r2 * (1.0 / 362880 + r2 * (-1.0 / 39916800)))));
  const double c =
      1.0 + r2 * (-0.5 + r2 * (1.0 / 24 + r2 * (-1.0 / 720 +
                  r2 * (1.0 / 40320 + r2 * (-1.0 / 3628800 +
                  r2 * (1.0 / 479001600))))));
  if (which == 2) return (float)((q & 1) ? -c / s : s / c);
  if (which == 1) q += 1;  // cos x = sin(x + pi/2)
  const double v = (q & 1) ? c : s;
  return (float)((q & 2) ? -v : v);
}

}  // namespace sp_trig
