// K5: 3x3 / stride-1 SAME convolution + bias + LeakyReLU(0.1) or linear,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_conv.py ::
// conv3x3_fused_roll2 (and its twins conv3x3_fused_roll and conv3x3_fused,
// which compute the same function with other TPU layouts). Input x is NHWC
// (B, H, W, Cin), channel stride 1 (the port's channels_last activations
// read as they are); weights w are (Cout, 3, 3, Cin) in memory (the port's
// channels_last OIHW buffers), bias float32 or bf16 (Cout). Output y is NHWC
// (B, H, W, Cout), contiguous, in x's type:
//
//   y[b, i, j, n] = act(sum_{ky, kx, c} x[b, i+ky-1, j+kx-1, c]
//                                         * w[n, ky, kx, c] + bias[n])
//
// with zero padding outside the image, float32 accumulation for float32 or
// bf16 operands, and one rounding to x's type at the store.
//
// Two kernels, chosen by the operands' type in the C entry:
//
// bf16: conv3x3_mma_kernel (conv3x3_mma.cuh), an implicit GEMM on the tensor
// cores (wgmma) with asynchronous tile loads and the epilogue fused. What
// bounds it and what its design does about that is written there: shared-
// memory bandwidth in the main loop, unhidden fill and epilogue per tile,
// idle multiprocessors at the 26 x 26 and 13 x 13 tile counts. The 29
// eligible layers of yolov3 at 416, batch 8, are 370 GFLOP: 0.374 ms at the
// 989 TFLOP/s bf16 peak.
//
// float32: conv3x3_kernel below, on the CUDA cores. The float32 bar (atol
// 5e-5, rtol 1e-4 against the float32 plain version) and precision
// "highest" rule out TF32, so the tensor cores are not an option for
// float32 operands; the 67 TFLOP/s float32 rate makes 5.5 ms the least the
// 29 layers could take. Its design: implicit GEMM with
// M = B*H*W output pixels, N = Cout, K = 9*Cin in (tap, channel) order. A
// block of 256 threads computes a 128-pixel x 128-channel tile; thread
// (ty, tx) of a 16 x 16 grid owns an 8 x 8 sub-tile (pixels ty*4+{0..3} and
// 64+ty*4+{0..3}, channels likewise with tx), 64 float32 accumulators in
// registers. The reduction walks K in chunks of 8 channels of one tap: each
// thread fetches 4 consecutive channels of one pixel (x) and of one output
// channel's weight row (w) per chunk, zero where the tap falls outside the
// image (the ragged edges are masked here, with no padding copy), into
// registers while the block computes the previous chunk out of the other of
// two shared-memory buffers; operands are read back as 16-byte vectors, so
// each chunk costs 4 shared loads per 64 multiply-adds. Products use
// __fmaf_rn (one rounding each; the -fmad=false build flag does not touch
// the intrinsic). The epilogue adds the bias, applies the activation and
// makes one store per output element.

#include "conv3x3_mma.cuh"

#define K5_THREADS 256
#define K5_BM 128
#define K5_BN 128
#define K5_BK 8
#define K5_PAD 4  // row stride 132 floats: 16-byte aligned, spreads banks

// four consecutive elements of a row
__device__ __forceinline__ float4 k5_load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool LEAKY>
__global__ void __launch_bounds__(K5_THREADS)
conv3x3_kernel(const float* __restrict__ x, long long sb, long long sy,
               long long sx, const float* __restrict__ w,
               const void* __restrict__ bias, int bias_bf16, int batch, int h,
               int wd, int cin, int cout, float* __restrict__ y) {
  __shared__ __align__(16) float as[2][K5_BK][K5_BM + K5_PAD];
  __shared__ __align__(16) float bs[2][K5_BK][K5_BN + K5_PAD];

  const int tid = threadIdx.x;
  const int hw = h * wd;
  const long long m_total = (long long)batch * hw;
  const long long m0 = (long long)blockIdx.x * K5_BM;
  const int n0 = blockIdx.y * K5_BN;

  // this thread's load slots: pixel (for x) / output channel (for w)
  // ld_row = tid / 2, channels ld_k .. ld_k + 3 of each 8-channel chunk
  const int ld_row = tid >> 1;
  const int ld_k = (tid & 1) * 4;
  const long long gm = m0 + ld_row;
  const bool m_ok = gm < m_total;
  int pb = 0, py = 0, px = 0;
  if (m_ok) {
    pb = (int)(gm / hw);
    const int rem = (int)(gm - (long long)pb * hw);
    py = rem / wd;
    px = rem - py * wd;
  }
  const float* x_pix = x + pb * sb + ld_k;
  const int gn = n0 + ld_row;
  const bool n_ok = gn < cout;
  const float* w_row = w + (long long)(n_ok ? gn : 0) * 9 * cin + ld_k;

  const int chunks_per_tap = cin / K5_BK;
  const int steps = 9 * chunks_per_tap;

  // fetch chunk `s` (tap s / chunks_per_tap, channels c0..c0+7) to registers
  auto fetch = [&](int s, float4& av, float4& bv) {
    const int tap = s / chunks_per_tap;
    const int c0 = (s - tap * chunks_per_tap) * K5_BK;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int yy = py + ky - 1, xx = px + kx - 1;
    av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m_ok && yy >= 0 && yy < h && xx >= 0 && xx < wd)
      av = k5_load4(x_pix + yy * sy + xx * sx + c0);
    bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n_ok) bv = k5_load4(w_row + (long long)tap * cin + c0);
  };
  auto stash = [&](int buf, const float4& av, const float4& bv) {
    as[buf][ld_k + 0][ld_row] = av.x;
    as[buf][ld_k + 1][ld_row] = av.y;
    as[buf][ld_k + 2][ld_row] = av.z;
    as[buf][ld_k + 3][ld_row] = av.w;
    bs[buf][ld_k + 0][ld_row] = bv.x;
    bs[buf][ld_k + 1][ld_row] = bv.y;
    bs[buf][ld_k + 2][ld_row] = bv.z;
    bs[buf][ld_k + 3][ld_row] = bv.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int ty = tid >> 4, tx = tid & 15;
  float4 av, bv;
  fetch(0, av, bv);
  stash(0, av, bv);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < steps;
    if (more) fetch(s + 1, av, bv);  // global loads in flight during the math
#pragma unroll
    for (int k = 0; k < K5_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1, av, bv);
    __syncthreads();
  }

  // epilogue: bias, activation, one store per element
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= m_total) continue;
    float* out = y + m * cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= cout) continue;
      float v = acc[i][j] + k5_bias(bias, bias_bf16, n);
      if (LEAKY) v = v > 0.0f ? v : 0.1f * v;
      out[n] = v;
    }
  }
}


// launches the tensor-core kernel on BM x 128 tiles; its dynamic shared
// memory is above the 48 KB a kernel gets without asking
template <int BM>
static cudaError_t launch_mma(bool leaky, cudaStream_t s, const bf16_bits* x,
                              long long sb, long long sy, long long sx,
                              const bf16_bits* w, const void* bias,
                              int bias_bf16, int batch, int h, int wd, int cin,
                              int cout, bf16_bits* y) {
  constexpr int SMEM = (int)k5t_smem_bytes(BM);
  auto kernel = leaky ? conv3x3_mma_kernel<BM, true>
                      : conv3x3_mma_kernel<BM, false>;
  static bool allowed[2][WG_MAX_DEVICES] = {};  // per kernel instance
  cudaError_t e = wg_allow_smem(kernel, SMEM, allowed[leaky]);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((batch * h * wd + BM - 1) / BM),
                  (unsigned)((cout + K5T_BN - 1) / K5T_BN));
  kernel<<<grid, BM * 2, SMEM, s>>>(x, sb, sy, sx, w, bias, bias_bf16, batch,
                                    h, wd, cin, cout, y);
  return cudaGetLastError();
}

// C entry (ctypes). x: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) NHWC
// activation addressed as x[b * sb + i * sy + j * sx + channel], channel
// stride 1; w: the same type, (cout, 3, 3, cin) contiguous; bias: float32
// (bias_bf16 = 0) or bf16 (bias_bf16 = 1), (cout); y: x's type, (batch, h,
// wd, cout) contiguous. leaky = 1 applies LeakyReLU(0.1), 0 is linear.
// float32 runs the CUDA-core kernel (TF32 would miss the float32 bar):
// sb, sy, sx multiples of 4, cin a multiple of 8; block_m is not read.
// bf16 runs the tensor-core kernel on block_m x 128 tiles (the caller's
// tile plan: 128 or 64): sb, sy, sx multiples of 8 (16-byte rows), cin a
// multiple of 128, batch * h * wd below 2^31 - 128. Launches on `stream`,
// allocates nothing, returns the first CUDA error or 0.
extern "C" int yolo_conv3x3_fused(const void* x, long long sb, long long sy,
                                  long long sx, int is_bf16, const void* w,
                                  const void* bias, int bias_bf16, int batch,
                                  int h, int wd, int cin, int cout, int leaky,
                                  int block_m, void* y, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const long long m_total = (long long)batch * h * wd;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (cin < 128 || cin % 128 || sb % 8 || sy % 8 || sx % 8 ||
        m_total > 0x7fffffffLL - 128)
      return (int)cudaErrorInvalidValue;
    const bf16_bits* xb = (const bf16_bits*)x;
    const bf16_bits* wb = (const bf16_bits*)w;
    if (block_m == 128)
      return (int)launch_mma<128>(leaky != 0, s, xb, sb, sy, sx, wb, bias,
                                  bias_bf16, batch, h, wd, cin, cout,
                                  (bf16_bits*)y);
    if (block_m == 64)
      return (int)launch_mma<64>(leaky != 0, s, xb, sb, sy, sx, wb, bias,
                                 bias_bf16, batch, h, wd, cin, cout,
                                 (bf16_bits*)y);
    return (int)cudaErrorInvalidValue;
  }
  if (cin < K5_BK || cin % K5_BK || sb % 4 || sy % 4 || sx % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m_total + K5_BM - 1) / K5_BM),
                  (unsigned)((cout + K5_BN - 1) / K5_BN));
  if (leaky)
    conv3x3_kernel<true><<<grid, K5_THREADS, 0, s>>>(
        (const float*)x, sb, sy, sx, (const float*)w, bias, bias_bf16, batch,
        h, wd, cin, cout, (float*)y);
  else
    conv3x3_kernel<false><<<grid, K5_THREADS, 0, s>>>(
        (const float*)x, sb, sy, sx, (const float*)w, bias, bias_bf16, batch,
        h, wd, cin, cout, (float*)y);
  return (int)cudaGetLastError();
}
