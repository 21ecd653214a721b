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
// Two kernels, both implicit GEMMs on the tensor cores (wgmma), chosen by
// the operands' type in the C entry. GEMM view: M = B*H*W output pixels
// (tiled linearly over the flattened pixels), N = Cout, K = 9*Cin in (tap,
// channel) order; both operands K-major as they lie in memory.
//
// bf16: conv3x3_mma_kernel (conv3x3_mma.cuh). What bounds it and what its
// design does about that is written there: shared-memory bandwidth in the
// main loop, unhidden fill and epilogue per tile, idle multiprocessors at
// the 26 x 26 and 13 x 13 tile counts. The 29 eligible layers of yolov3 at
// 416, batch 8, are 370 GFLOP: 0.374 ms at the 989 TFLOP/s bf16 peak.
//
// float32: conv3x3_tf32x3_kernel below, split TF32 ("3xTF32",
// wgmma_common.cuh): every operand is split into two TF32 parts and each
// product is three TF32 products (hi * hi + hi * lo + lo * hi), which holds
// the float32 bar (atol 5e-5, rtol 1e-4 against the float32 plain version)
// where one TF32 pass misses it by an order of magnitude. The tensor cores
// run TF32 at 495 TFLOP/s dense, so the 29 layers' 370 GFLOP need at least
// 3 x 370 / 495 = 2.24 ms of products, against 5.52 ms on the CUDA cores
// (67 TFLOP/s), which the kernel this one replaced reached 37% of (15.0
// ms). That floor (operations) bounds it; what holds it above the floor
// is the barrier and the drain before each step's promotion, shared-memory
// bandwidth (the products' B reads and the copies use most of it) and
// idle multiprocessors at the 13 x 13 and 26 x 26 tile counts. Its design,
// from the bf16 kernel's: BM x 128 tiles (BM from plan_tiles, which at
// float32 counts waves of tiles), the same SAME padding and ragged edges
// by cp.async with source size 0, the same fused epilogue; a K step
// is ONE tap's 32 channels (a 128-byte swizzled row of float32), 32-channel
// blocks outermost and the taps inside, so the nine taps of a block re-read
// the same pixels shifted and find them in L1. The activations are split
// in registers (A, read from the swizzled tile as wgmma's register
// fragment, wg_gemm_tf32x3); the weights arrive split, as two tensors the
// wrapper makes once per weight tensor (ops/tf32.py :: tf32_operands), and
// are copied into a hi and a lo tile: splitting them in the kernel costs a
// pass over the tile in shared memory every step, whose bandwidth the
// products' operand reads already mostly use (PERF.md: the 29 layers took
// longer so). The tensor cores truncate when they align the addends,
// so each 32-channel step is summed there from zero and the steps are
// added on the CUDA cores (K reaches 9 x 1,024 = 9,216). A ring of four
// steps keeps three in flight (48 KB a step at 128 rows). The epilogue
// stages float32 rows through the freed ring and stores them in 16-byte
// pieces. Inputs are finite (the split of an infinity is not).

#include "conv3x3_mma.cuh"

#define K5F_STAGES 4    // K steps in the float32 kernel's ring
#define K5F_C_ROW 544   // bytes of one staged float32 output row: 128
                        // floats + 32, so that a half-warp's fragment
                        // stores hit 32 banks

// a float32 stage: the A tile (bm pixel rows), the B hi and lo tiles (128
// output channel rows each), 32 channels a row
__host__ __device__ constexpr uint32_t k5f_stage_bytes(int bm) {
  return (uint32_t)(bm + 2 * K5T_BN) * WG_ROW;
}
// dynamic shared memory: slack to reach a 1,024-byte boundary, the ring,
// the tile's 128 bias values
__host__ __device__ constexpr uint32_t k5f_smem_bytes(int bm) {
  return 1024u + K5F_STAGES * k5f_stage_bytes(bm) + K5T_BN * 4u;
}
static_assert(k5f_smem_bytes(128) <= 232448,
              "a block's shared memory fits the 227 KB an H100 allows");
static_assert(K5F_STAGES * k5f_stage_bytes(64) >= 64 * K5F_C_ROW &&
                  K5F_STAGES * k5f_stage_bytes(128) >= 128 * K5F_C_ROW,
              "the staging tile fits the ring");

template <int BM, bool LEAKY>
__global__ void __launch_bounds__(BM * 2)
conv3x3_tf32x3_kernel(const float* __restrict__ x, long long sb,
                      long long sy, long long sx, const float* __restrict__ w,
                      const float* __restrict__ w_lo,
                      const void* __restrict__ bias, int bias_bf16, int batch,
                      int h, int wd, int cin, int cout,
                      float* __restrict__ y) {
  constexpr int THREADS = BM * 2;     // BM / 64 warpgroups
  constexpr int RPP = THREADS / 8;    // tile rows one pass of copies covers
  constexpr int A_IT = BM / RPP;      // copies per thread per step: A
  constexpr int B_IT = K5T_BN / RPP;  //                              B
  constexpr uint32_t A_BYTES = BM * WG_ROW;
  constexpr uint32_t STAGE_BYTES = k5f_stage_bytes(BM);

  extern __shared__ unsigned char k5f_smem[];
  const uint32_t raw = wg_smem_u32(k5f_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = k5f_smem + (ring - raw);
  float* sbias =
      reinterpret_cast<float*>(ring_ptr + K5F_STAGES * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int hw = h * wd;
  const int m_total = batch * hw;  // the C entry keeps it under 2^31
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * K5T_BN;

  if (tid < K5T_BN)
    sbias[tid] = n0 + tid < cout ? k5_bias(bias, bias_bf16, n0 + tid) : 0.0f;

  // this thread's copies: 16-byte chunk j (floats 4j .. 4j + 3) of rows
  // r0, r0 + RPP, ... of the A tile (pixels) and of the B tile (output
  // channels); RPP % 8 == 0, so the swizzle term r & 7 is the same for all
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t row_off =
      (uint32_t)r0 * WG_ROW + (uint32_t)((j ^ (r0 & 7)) << 4);
  const float* a_src[A_IT];  // the row's pixel at the centre tap
  uint32_t a_taps[A_IT];     // bit t: tap t lies inside the image
#pragma unroll
  for (int i = 0; i < A_IT; ++i) {
    const int gm = m0 + r0 + i * RPP;
    a_src[i] = x;
    a_taps[i] = 0;
    if (gm < m_total) {
      const int pb = gm / hw;
      const int rem = gm - pb * hw;
      const int py = rem / wd;
      const int px = rem - py * wd;
      a_src[i] = x + pb * sb + py * sy + px * sx + j * 4;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = py + t / 3 - 1, xx = px + t % 3 - 1;
        if (yy >= 0 && yy < h && xx >= 0 && xx < wd) a_taps[i] |= 1u << t;
      }
    }
  }
  const long long w_row = 9LL * cin;
  const long long b_src = (long long)(n0 + r0) * w_row + j * 4;

  // one K step: tap ld_tap's channels ld_c0 .. + 31; A rows through L1
  // (the taps of a block re-read them shifted), B rows (hi, then lo)
  // bypass it
  const int steps = 9 * (cin / WG_F32);
  int ld_step = 0, ld_tap = 0, ld_c0 = 0;
  auto load_next = [&](int st) {
    if (ld_step < steps) {
      const uint32_t stage = ring + st * STAGE_BYTES;
      const int ky = ld_tap / 3, kx = ld_tap - ky * 3;
      const long long a_off = (ky - 1) * sy + (kx - 1) * sx + ld_c0;
      const long long b_off = (long long)ld_tap * cin + ld_c0;
#pragma unroll
      for (int i = 0; i < A_IT; ++i) {
        const bool ok = (a_taps[i] >> ld_tap) & 1u;
        wg_cp_async16_l1(stage + row_off + i * RPP * WG_ROW,
                         ok ? a_src[i] + a_off : x, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < B_IT; ++i) {
        const bool ok = n0 + r0 + i * RPP < cout;
        const long long off = ok ? b_src + i * RPP * w_row + b_off : 0;
        const uint32_t dst = stage + A_BYTES + row_off + i * RPP * WG_ROW;
        wg_cp_async16(dst, w + off, ok ? 16 : 0);
        wg_cp_async16(dst + K5T_BN * WG_ROW, w_lo + off, ok ? 16 : 0);
      }
      if (++ld_tap == 9) { ld_tap = 0; ld_c0 += WG_F32; }
      ++ld_step;
    }
    wg_cp_async_commit();
  };

  const int wg = tid >> 7;  // warpgroup: rows wg * 64 .. + 63 of the tile
  float sum[K5T_BN / 2];
  wg_gemm_tf32x3<BM, K5T_BN, K5T_BN, K5F_STAGES>(sum, steps, ring, ring_ptr,
                                                 wg, 0, load_next);

  // epilogue: bias, activation, into a float32 staging tile in the ring.
  // Fragment layout of m64n128: thread (warp, lane) of the warpgroup holds
  // rows warp * 16 + lane / 4 (+ 8), columns nb * 8 + (lane % 4) * 2 (+ 1).
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row_a = wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
#pragma unroll
  for (int nb = 0; nb < K5T_BN / 8; ++nb) {
    const int col = nb * 8 + col0;
    const float b0 = sbias[col], b1 = sbias[col + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v0 = sum[nb * 4 + hr * 2] + b0;
      float v1 = sum[nb * 4 + hr * 2 + 1] + b1;
      if (LEAKY) {
        v0 = v0 > 0.0f ? v0 : 0.1f * v0;
        v1 = v1 > 0.0f ? v1 : 0.1f * v1;
      }
      *reinterpret_cast<float2*>(ring_ptr + (row_a + hr * 8) * K5F_C_ROW +
                                 col * 4) = make_float2(v0, v1);
    }
  }
  __syncthreads();
  // whole output rows leave in 16-byte pieces: 32 threads a row
  const bool vec = cout % 4 == 0;  // rows of y start on 16-byte boundaries
#pragma unroll
  for (int it = 0; it < BM * 32 / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int row = idx >> 5, piece = idx & 31;
    const int m = m0 + row;
    const int n = n0 + piece * 4;
    if (m < m_total && n < cout) {
      const float4 v = *reinterpret_cast<const float4*>(
          ring_ptr + row * K5F_C_ROW + piece * 16);
      float* out = y + (long long)m * cout + n;
      if (vec) {
        *reinterpret_cast<float4*>(out) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < cout) out[q] = e[q];
      }
    }
  }
}

// launches the kernel of x's type on BM x 128 tiles; its dynamic shared
// memory is above the 48 KB a kernel gets without asking. w_lo: the float32
// kernel's lo weights (unread at bf16)
template <int BM, typename T>
static cudaError_t launch_k5(bool leaky, cudaStream_t s, const T* x,
                             long long sb, long long sy, long long sx,
                             const T* w, const T* w_lo, const void* bias,
                             int bias_bf16, int batch, int h, int wd, int cin,
                             int cout, T* y) {
  static bool allowed[2][WG_MAX_DEVICES] = {};  // per kernel instance
  const dim3 grid((unsigned)((batch * h * wd + BM - 1) / BM),
                  (unsigned)((cout + K5T_BN - 1) / K5T_BN));
  cudaError_t e;
  if constexpr (sizeof(T) == 4) {
    auto kernel = leaky ? conv3x3_tf32x3_kernel<BM, true>
                        : conv3x3_tf32x3_kernel<BM, false>;
    constexpr int SMEM = (int)k5f_smem_bytes(BM);
    e = wg_allow_smem(kernel, SMEM, allowed[leaky]);
    if (e != cudaSuccess) return e;
    kernel<<<grid, BM * 2, SMEM, s>>>(x, sb, sy, sx, w, w_lo, bias,
                                      bias_bf16, batch, h, wd, cin, cout, y);
  } else {
    auto kernel = leaky ? conv3x3_mma_kernel<BM, true>
                        : conv3x3_mma_kernel<BM, false>;
    constexpr int SMEM = (int)k5t_smem_bytes(BM);
    e = wg_allow_smem(kernel, SMEM, allowed[leaky]);
    if (e != cudaSuccess) return e;
    kernel<<<grid, BM * 2, SMEM, s>>>(x, sb, sy, sx, w, bias, bias_bf16,
                                      batch, h, wd, cin, cout, y);
  }
  return cudaGetLastError();
}

template <typename T>
static int launch_planned(int block_m, bool leaky, cudaStream_t s,
                          const void* x, long long sb, long long sy,
                          long long sx, const void* w, const void* w_lo,
                          const void* bias, int bias_bf16, int batch, int h,
                          int wd, int cin, int cout, void* y) {
  if (block_m == 128)
    return (int)launch_k5<128>(leaky, s, (const T*)x, sb, sy, sx,
                               (const T*)w, (const T*)w_lo, bias, bias_bf16,
                               batch, h, wd, cin, cout, (T*)y);
  if (block_m == 64)
    return (int)launch_k5<64>(leaky, s, (const T*)x, sb, sy, sx, (const T*)w,
                              (const T*)w_lo, bias, bias_bf16, batch, h, wd,
                              cin, cout, (T*)y);
  return (int)cudaErrorInvalidValue;
}

// C entry (ctypes). x: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) NHWC
// activation addressed as x[b * sb + i * sy + j * sx + channel], channel
// stride 1, 16-byte aligned; w: the same type, (cout, 3, 3, cin)
// contiguous; bias: float32 (bias_bf16 = 0) or bf16 (bias_bf16 = 1),
// (cout); y: x's type, (batch, h, wd, cout) contiguous. leaky = 1 applies
// LeakyReLU(0.1), 0 is linear. Tiles of block_m x 128 (the caller's tile
// plan: 128 or 64); batch * h * wd below 2^31 - 128. float32 runs the
// 3xTF32 kernel: w holds the weights' TF32 hi parts and w_lo, laid out as
// w, their TF32 lo parts (ops/tf32.py :: tf32_operands); sb, sy, sx
// multiples of 4, cin a multiple of 32. bf16 runs the bf16 kernel (w_lo is
// not read): sb, sy, sx multiples of 8 (16-byte rows), cin a multiple of
// 128. Launches on `stream`, allocates nothing, returns the first CUDA
// error or 0.
extern "C" int yolo_conv3x3_fused(const void* x, long long sb, long long sy,
                                  long long sx, int is_bf16, const void* w,
                                  const void* w_lo, const void* bias,
                                  int bias_bf16, int batch, int h, int wd,
                                  int cin, int cout, int leaky, int block_m,
                                  void* y, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cout < 1 ||
      (long long)batch * h * wd > 0x7fffffffLL - 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int row = is_bf16 ? 8 : 4;  // elements of a 16-byte piece
  const int cin_step = is_bf16 ? K5T_BK : WG_F32;
  if (cin < cin_step || cin % cin_step || sb % row || sy % row || sx % row ||
      (!is_bf16 && (w_lo == nullptr || (uintptr_t)w_lo % 16)))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_planned<bf16_bits>(block_m, leaky != 0, s, x, sb, sy, sx, w,
                                     w_lo, bias, bias_bf16, batch, h, wd, cin,
                                     cout, y);
  return launch_planned<float>(block_m, leaky != 0, s, x, sb, sy, sx, w, w_lo,
                               bias, bias_bf16, batch, h, wd, cin, cout, y);
}
