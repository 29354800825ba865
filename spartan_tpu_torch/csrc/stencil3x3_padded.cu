// One application of a 3x3 zero-boundary stencil over padded storage, for
// Hopper (sm_90a).
//
// Replaces spartan_tpu/backend/kernels/stencil_pallas.py:stencil3x3_padded
// (K6a) and, with halo rows, the per-device call of its row-band sharded
// form stencil3x3_padded_sharded (K6b: the same pallas_call given `top` and
// `bot`, :301, :363-366).  The layout is the reference's: an (n + 16,
// m + 256) array, the interior at [8 : 8 + n, 128 : 128 + m], the ring
// zero.  On the TPU the 8/128 pads put every DMA offset on Mosaic's tile
// grid; here the 128-float left pad keeps the interior 512-byte aligned and
// the ring is the zero boundary: a tile's halo loads read its zeros, and
// only a tile's overhang past the ring is cut by the bounds check.  The
// TPU kernel picks a row block to fit VMEM, double-buffers slab DMAs and
// aliases its output onto a scratch buffer; shapes off its grid take an
// XLA fallback.  Here one launch computes one application for any n >= 1
// and m >= 1, writing the interior of buf in place; the wrapper
// (backend/kernels/stencil.py) loops over applications on the host,
// ping-ponging xp and buf.
//
// K6b: `top` and `bot` are one row each of the padded width m + 256 (the
// reference's are (8, m + 256) blocks, 8 being the TPU's sublane tile; a
// 3x3 stencil reads one row).  Row -1 of the interior reads `top` and row n
// reads `bot` in place of the ring; the sharded wrapper fills them with the
// neighbouring bands' edge rows, zeros at the global edge.  Without them
// the launch is K6a's instantiation.  Device code, rounding, bound and
// design: stencil3x3.cuh.

#include "stencil3x3.cuh"

#define PAD_R 8
#define PAD_C 128

template <typename T>
static int run(const void* xp, const void* add, const void* top,
               const void* bot, void* buf, int64_t n, int64_t m,
               const StencilCoeffs& c, cudaStream_t s) {
  const int64_t stride = m + 2 * PAD_C;
  const int64_t origin = PAD_R * stride + PAD_C;
  const T* x = static_cast<const T*>(xp) + origin;
  T* out = static_cast<T*>(buf) + origin;
  const T* g = add == nullptr ? nullptr : static_cast<const T*>(add) + origin;
  if (top != nullptr) {
    const T* t = static_cast<const T*>(top) + PAD_C;
    const T* b = static_cast<const T*>(bot) + PAD_C;
    if (g == nullptr)
      return st_launch<T, false, true>(x, stride, -PAD_R, n + PAD_R, -PAD_C,
                                       m + PAD_C, nullptr, out, stride, n, m,
                                       c, s, t, b);
    return st_launch<T, true, true>(x, stride, -PAD_R, n + PAD_R, -PAD_C,
                                    m + PAD_C, g, out, stride, n, m, c, s, t,
                                    b);
  }
  if (g == nullptr)
    return st_launch<T, false>(x, stride, -PAD_R, n + PAD_R, -PAD_C,
                               m + PAD_C, nullptr, out, stride, n, m, c, s);
  return st_launch<T, true>(x, stride, -PAD_R, n + PAD_R, -PAD_C, m + PAD_C,
                            g, out, stride, n, m, c, s);
}

extern "C" {

// xp, buf and add (add may be NULL): contiguous, distinct (n + 16, m + 256)
// arrays of one dtype on one device (dtype 0 float32, 1 bfloat16, 2
// float16), their pad rings zero; top and bot: both NULL (K6a) or both
// contiguous rows of m + 256 elements of that dtype (K6b); coeffs: nine
// host floats, row-major; applied: bit k set if tap k is applied.  Writes
// the interior of buf only.  Returns cudaGetLastError() of the launch (0 on
// success).
int spartan_stencil3x3_padded(const void* xp, const void* add, const void* top,
                              const void* bot, void* buf, int64_t n, int64_t m,
                              int dtype, const float* coeffs, int applied,
                              void* stream) {
  if (n < 1 || m < 1 || (top == nullptr) != (bot == nullptr))
    return (int)cudaErrorInvalidValue;
  const StencilCoeffs c = st_coeffs(coeffs, applied);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(xp, add, top, bot, buf, n, m, c, s);
    case 1: return run<__nv_bfloat16>(xp, add, top, bot, buf, n, m, c, s);
    case 2: return run<__half>(xp, add, top, bot, buf, n, m, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
