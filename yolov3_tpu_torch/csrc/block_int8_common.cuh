// The float and index arithmetic of the fused int8 residual block (K6,
// block_int8.cu), as __device__ functions shared with the ingredient probes
// (probe.cu): the probes run the code K6 runs, not a copy of it.
//
// Float contract (see block_int8.cu): built with -fmad=false, so every
// multiply and add below stays a separate rounding, and rounding to integer
// is half to even (what torch.round and numpy.round do), never roundf's half
// away from zero.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float k6_leaky(float y) {
  return y > 0.0f ? y : 0.1f * y;
}

// 1.5 * 2^23. Added to a float of magnitude below 2^22 it leaves that
// float's nearest integer, ties to even (the constant is even), as the low
// bits of a float whose unit in the last place is 1; the same sum carries
// small integers between int and float. These run on the floating-point
// pipes, where rintf and the int <-> float conversions take the conversion
// unit at a quarter of their rate, and K6's epilogues are bound by that.
#define K6_MAGIC 12582912.0f
#define K6_MAGIC_BITS 0x4B400000

// clip(round-half-even(f), -127, 127), as a float: equal to
// fminf(fmaxf(rintf(f), -127), 127) for every f. Below 2^22 the rounding is
// rintf's; from there on both clip to +-127, and NaN becomes -127 in both.
__device__ __forceinline__ float k6_round_clip(float f) {
  const float r = (f + K6_MAGIC) - K6_MAGIC;
  return fminf(fmaxf(r, -127.0f), 127.0f);
}

// an integral float of magnitude below 2^22 (a quantized level) -> int
__device__ __forceinline__ int k6_level_int(float q) {
  return __float_as_int(q + K6_MAGIC) - K6_MAGIC_BITS;
}

// an int of magnitude below 2^22 (an int8 input) -> float, exactly
__device__ __forceinline__ float k6_small_float(int v) {
  return __int_as_float(K6_MAGIC_BITS + v) - K6_MAGIC;
}

// an int32 conv sum -> dequantize (the scale bakes the input scale) -> add
// the bias -> leaky 0.1: the unfused walk's multiply, add, compare, multiply
__device__ __forceinline__ float k6_dequant_leaky(int acc, float deq,
                                                  float bias) {
  return k6_leaky((float)acc * deq + bias);
}

// a float activation -> its quantized level at 1 / inv_scale, as a float
__device__ __forceinline__ float k6_requant(float y, float inv_scale) {
  return k6_round_clip(y * inv_scale);
}

// Row-major index `flat` of a slab `row_width` pixels wide whose first pixel
// sits at image row `row0`, column `col0` -> that pixel's image coordinates.
__device__ __forceinline__ void k6_slab_coords(int flat, int row_width,
                                               int row0, int col0, int* gy,
                                               int* gx) {
  *gy = row0 + flat / row_width;
  *gx = col0 + flat % row_width;
}

__device__ __forceinline__ bool k6_in_image(int gy, int gx, int h, int w) {
  return gy >= 0 && gy < h && gx >= 0 && gx < w;
}

// The validity mask of a slab pixel: inside the (h, w) image or not. Pixels
// outside read as zero, which is the 3x3 conv's SAME padding.
__device__ __forceinline__ bool k6_slab_valid(int flat, int row_width,
                                              int row0, int col0, int h,
                                              int w) {
  int gy, gx;
  k6_slab_coords(flat, row_width, row0, col0, &gy, &gx);
  return k6_in_image(gy, gx, h, w);
}
