// K5: 3x3 / stride-1 SAME convolution + bias + LeakyReLU(0.1) or linear,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_conv.py ::
// conv3x3_fused_roll2 (and its twins conv3x3_fused_roll and conv3x3_fused,
// which compute the same function with other TPU layouts). Input x is NHWC
// (B, H, W, Cin), channel stride 1 (the port's channels_last activations
// read as they are); weights w are (Cout, 3, 3, Cin) in memory (the port's
// channels_last OIHW buffers), bias float32 (Cout). Output y is NHWC
// (B, H, W, Cout), contiguous, in x's type:
//
//   y[b, i, j, n] = act(sum_{ky, kx, c} x[b, i+ky-1, j+kx-1, c]
//                                         * w[n, ky, kx, c] + bias[n])
//
// with zero padding outside the image, float32 accumulation for float32 or
// bf16 operands, and one rounding to x's type at the store.
//
// What bounds it on the H100: arithmetic. The 29 eligible layers of yolov3
// at 416 do 370 GFLOP per batch-8 call while moving about 0.6 GB, so a
// kernel at the 67 TFLOP/s float32 CUDA-core rate would need 5.5 ms; cuDNN
// reaches the tensor cores (989 TFLOP/s bf16, 495 TF32) and will stay far
// ahead of this kernel. A later PR moves the main loop to wgmma with TMA
// tile loads.
//
// Design (a simple kernel that is right): implicit GEMM with
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define K5_THREADS 256
#define K5_BM 128
#define K5_BN 128
#define K5_BK 8
#define K5_PAD 4  // row stride 132 floats: 16-byte aligned, spreads banks

typedef unsigned short bf16_bits;

// four consecutive elements of a row, widened to float (exact for bf16)
__device__ __forceinline__ float4 k5_load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 k5_load4(const bf16_bits* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void k5_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void k5_store(bf16_bits* p, float v) {
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
}

template <typename T, bool LEAKY>
__global__ void __launch_bounds__(K5_THREADS)
conv3x3_kernel(const T* __restrict__ x, long long sb, long long sy,
               long long sx, const T* __restrict__ w,
               const float* __restrict__ bias, int batch, int h, int wd,
               int cin, int cout, T* __restrict__ y) {
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
  const T* x_pix = x + pb * sb + ld_k;
  const int gn = n0 + ld_row;
  const bool n_ok = gn < cout;
  const T* w_row = w + (long long)(n_ok ? gn : 0) * 9 * cin + ld_k;

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

  // epilogue: bias, activation, one store per element in x's type
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= m_total) continue;
    T* out = y + m * cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n >= cout) continue;
      float v = acc[i][j] + bias[n];
      if (LEAKY) v = v > 0.0f ? v : 0.1f * v;
      k5_store(out + n, v);
    }
  }
}

template <typename T>
static void launch_conv(bool leaky, dim3 grid, cudaStream_t s, const T* x,
                        long long sb, long long sy, long long sx, const T* w,
                        const float* bias, int batch, int h, int wd, int cin,
                        int cout, T* y) {
  if (leaky)
    conv3x3_kernel<T, true><<<grid, K5_THREADS, 0, s>>>(
        x, sb, sy, sx, w, bias, batch, h, wd, cin, cout, y);
  else
    conv3x3_kernel<T, false><<<grid, K5_THREADS, 0, s>>>(
        x, sb, sy, sx, w, bias, batch, h, wd, cin, cout, y);
}

// C entry (ctypes). x: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) NHWC
// activation addressed as x[b * sb + i * sy + j * sx + channel], channel
// stride 1, with sb, sy, sx multiples of 4; w: the same type, (cout, 3, 3,
// cin) contiguous; bias: float32 (cout); y: x's type, (batch, h, wd, cout)
// contiguous. cin must be a multiple of 8 (the eligibility gate asks for
// 128). leaky = 1 applies LeakyReLU(0.1), 0 is linear. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int yolo_conv3x3_fused(const void* x, long long sb, long long sy,
                                  long long sx, int is_bf16, const void* w,
                                  const float* bias, int batch, int h, int wd,
                                  int cin, int cout, int leaky, void* y,
                                  void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cin < K5_BK || cin % K5_BK != 0 ||
      cout < 1 || sb % 4 || sy % 4 || sx % 4)
    return (int)cudaErrorInvalidValue;
  const long long m_total = (long long)batch * h * wd;
  const dim3 grid((unsigned)((m_total + K5_BM - 1) / K5_BM),
                  (unsigned)((cout + K5_BN - 1) / K5_BN));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch_conv<bf16_bits>(leaky != 0, grid, s, (const bf16_bits*)x, sb, sy,
                           sx, (const bf16_bits*)w, bias, batch, h, wd, cin,
                           cout, (bf16_bits*)y);
  else
    launch_conv<float>(leaky != 0, grid, s, (const float*)x, sb, sy, sx,
                       (const float*)w, bias, batch, h, wd, cin, cout,
                       (float*)y);
  return (int)cudaGetLastError();
}
