// K5 on the tensor cores: the bf16 implicit-GEMM kernel of the fused 3x3
// convolution, on Hopper's warpgroup matrix multiply (wgmma), CUDA C++ for
// sm_90a. Included by conv3x3.cu, which holds the C entry and the float32
// kernel. Its copies, swizzle, descriptors, products and float32 promotion
// are wgmma_common.cuh's, which K4's bf16 kernel (decode_fused.cu, a 1x1
// convolution with the decode as its epilogue) shares.
//
// GEMM view: M = B*H*W output pixels (tiled linearly over the flattened
// pixels, so no tile row is wasted at 13 x 13), N = Cout, K = 9*Cin. Both
// operands are K-major in memory as they are: a pixel's channels are
// contiguous in the NHWC activation, a filter's (tap, channel) run is
// contiguous in the (Cout, 3, 3, Cin) weights.
//
// One block computes a BM x 128 output tile with BM / 64 warpgroups; each
// warpgroup owns 64 rows and runs wgmma.m64n128k16 with both operands read
// from shared memory. An operand tile is 64 channels of ONE tap (Cin % 128
// == 0, so it never straddles a tap): 128-byte rows, laid out with the
// 128-byte swizzle the wgmma descriptors name (16-byte chunk j of row r sits
// at chunk j ^ (r & 7); tiles start on 1,024-byte boundaries). Operands stay
// bf16 from device memory to the tensor cores. A K step is two such tiles
// of A and of B; a ring of K5T_STAGES steps holds one step being multiplied
// and two in flight.
//
// Loads are 16-byte cp.async copies. A row of an A tile is one pixel's 64
// channels at tap (ky, kx): where the tap falls outside the image, or the
// row is past M, the copy is made with a source size of 0 and fills the
// row with zeros; that is the SAME padding and the ragged M edge in one
// mechanism, for any H and W. Each thread works out its rows' pixel and the
// 9 taps' validity once per tile. B rows past Cout are zero-filled the same
// way. K runs over 64-channel blocks outermost and the 9 taps inside, so a
// block re-reads the same pixels nine times shifted and finds them in L1.
//
// float32 sum: the tensor cores truncate when they align the addends, so a
// step's products are summed there and the steps are added on the CUDA
// cores (see `sum` in the kernel).
//
// Epilogue: sum + bias, LeakyReLU(0.1) or nothing, one rounding to bf16,
// staged through the (by then free) ring so that the stores to device
// memory are 16-byte pieces of whole output rows. The element order is the
// plain version's; only the order of the float32 sum differs from it.
//
// What bounds it: with both operands in shared memory a 128 x 128 x 128 step
// moves 64 KB into shared memory and the two warpgroups read 96 KB out of
// it, about 1,280 cycles of the 128 bytes a cycle a multiprocessor has,
// against 980 cycles of tensor-core work; a wider tile would halve that but
// its accumulators and their float32 sums do not fit the register file.
// Beside the main loop a tile pays its fill latency and its epilogue with
// nothing overlapped (one block a multiprocessor: 171 registers a thread,
// 193 KB), and the tile counts of the 26 x 26 and 13 x 13 layers leave
// multiprocessors idle (172 and 88 tiles on 132).

#pragma once

#include <cuda_bf16.h>

#include "wgmma_common.cuh"

typedef unsigned short bf16_bits;

#define K5T_BN 128        // output channels of a tile (wgmma n)
#define K5T_BK 128        // channels of one tap per K step: two halves of
#define K5T_HALF WG_HALF  // 64 channels, each a tile of 128-byte rows
#define K5T_ROW WG_ROW    // bytes of one operand tile row: 64 bf16
#define K5T_STAGES 3      // K steps in the ring: one multiplied, two in flight
#define K5T_C_ROW 272     // bytes of one staged output row: 128 bf16 + 16,
                          // so that a warp's fragment stores hit 32 banks

// a stage: the two A half-tiles (bm rows each), then the two B half-tiles
__host__ __device__ constexpr uint32_t k5t_stage_bytes(int bm) {
  return 2u * (uint32_t)(bm + K5T_BN) * K5T_ROW;
}
// the ring also serves as the epilogue's staging tile
__host__ __device__ constexpr uint32_t k5t_ring_bytes(int bm) {
  return K5T_STAGES * k5t_stage_bytes(bm);
}
static_assert(K5T_STAGES * k5t_stage_bytes(64) >= 64 * K5T_C_ROW &&
                  K5T_STAGES * k5t_stage_bytes(128) >= 128 * K5T_C_ROW,
              "the staging tile fits the ring");
// dynamic shared memory of a block: slack to reach a 1,024-byte boundary,
// the ring, the tile's 128 bias values
__host__ __device__ constexpr uint32_t k5t_smem_bytes(int bm) {
  return 1024u + k5t_ring_bytes(bm) + K5T_BN * 4u;
}

static_assert(k5t_smem_bytes(128) <= 232448,
              "a block's shared memory fits the 227 KB an H100 allows");

__device__ __forceinline__ float k5_widen(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);
}
// the bias in the type it has: a bf16 bias widens exactly
__device__ __forceinline__ float k5_bias(const void* bias, int bias_bf16,
                                         int n) {
  return bias_bf16 ? k5_widen(static_cast<const bf16_bits*>(bias)[n])
                   : static_cast<const float*>(bias)[n];
}

template <int BM, bool LEAKY>
__global__ void __launch_bounds__(BM * 2)
conv3x3_mma_kernel(const bf16_bits* __restrict__ x, long long sb,
                   long long sy, long long sx, const bf16_bits* __restrict__ w,
                   const void* __restrict__ bias, int bias_bf16, int batch,
                   int h, int wd, int cin, int cout,
                   bf16_bits* __restrict__ y) {
  constexpr int STAGES = K5T_STAGES;
  constexpr int THREADS = BM * 2;      // BM / 64 warpgroups
  constexpr int RPP = THREADS / 8;     // tile rows one pass of copies covers
  constexpr int A_IT = BM / RPP;       // copies per thread per half-tile: A
  constexpr int B_IT = K5T_BN / RPP;   //                                  B
  constexpr uint32_t A_BYTES = BM * K5T_ROW;      // one A half-tile
  constexpr uint32_t B_BYTES = K5T_BN * K5T_ROW;  // one B half-tile
  constexpr uint32_t STAGE_BYTES = k5t_stage_bytes(BM);

  extern __shared__ unsigned char k5t_smem[];
  const uint32_t raw = wg_smem_u32(k5t_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = k5t_smem + (ring - raw);
  float* sbias = reinterpret_cast<float*>(ring_ptr + k5t_ring_bytes(BM));

  const int tid = threadIdx.x;
  const int hw = h * wd;
  const int m_total = batch * hw;  // the C entry keeps it under 2^31
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * K5T_BN;

  if (tid < K5T_BN)
    sbias[tid] = n0 + tid < cout ? k5_bias(bias, bias_bf16, n0 + tid) : 0.0f;

  // this thread's copies: 16-byte chunk j of rows r0, r0 + RPP, ... of the A
  // half-tiles (pixels) and of the B half-tiles (output channels).
  // RPP % 8 == 0, so the swizzle term r & 7 is the same for all of them.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t row_off =
      (uint32_t)r0 * K5T_ROW + (uint32_t)((j ^ (r0 & 7)) << 4);
  const bf16_bits* a_src[A_IT];  // the row's pixel at the centre tap
  uint32_t a_taps[A_IT];         // bit t: tap t lies inside the image
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
      a_src[i] = x + pb * sb + py * sy + px * sx + j * 8;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = py + t / 3 - 1, xx = px + t % 3 - 1;
        if (yy >= 0 && yy < h && xx >= 0 && xx < wd) a_taps[i] |= 1u << t;
      }
    }
  }
  const long long w_row = 9LL * cin;
  const bf16_bits* b_src = w + (long long)(n0 + r0) * w_row + j * 8;

  // The K loop walks 64-channel blocks outermost and the 9 taps inside, two
  // (tap, block) halves a step: the taps of one block read the same pixels
  // shifted, so A rows go through L1 (cp.async.ca) and mostly hit there; B
  // rows are read once and bypass it. load_next copies the next step into
  // stage `st` as one cp.async group; past the last step an empty group
  // keeps the count of groups in step with the loop.
  const int steps = 9 * (cin / K5T_BK);
  int ld_step = 0, ld_tap = 0, ld_c0 = 0;
  auto load_next = [&](int st) {
    if (ld_step < steps) {
      const uint32_t stage = ring + st * STAGE_BYTES;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ky = ld_tap / 3, kx = ld_tap - ky * 3;
        const long long a_off = (ky - 1) * sy + (kx - 1) * sx + ld_c0;
        const long long b_off = (long long)ld_tap * cin + ld_c0;
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
          const bool ok = (a_taps[i] >> ld_tap) & 1u;
          wg_cp_async16_l1(stage + hf * A_BYTES + row_off + i * RPP * K5T_ROW,
                            ok ? a_src[i] + a_off : x, ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
          const bool ok = n0 + r0 + i * RPP < cout;
          wg_cp_async16(
              stage + 2 * A_BYTES + hf * B_BYTES + row_off + i * RPP * K5T_ROW,
              ok ? b_src + i * RPP * w_row + b_off : w, ok ? 16 : 0);
        }
        if (++ld_tap == 9) { ld_tap = 0; ld_c0 += K5T_HALF; }
      }
      ++ld_step;
    }
    wg_cp_async_commit();
  };

  // The tensor cores add a step's 128 products per output in float32 but
  // truncate when they align the addends, and over K = 4,608 that error
  // passes the float32 bar on outputs near zero. So `acc` restarts at every
  // step and the steps are added in `sum` on the CUDA cores, rounded to
  // nearest (wg_promote).
  float acc[64];
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;

  const int wg = tid >> 7;  // warpgroup: rows wg * 64 .. + 63 of the tile

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) load_next(p);

  int st = 0;  // the stage of step s
  for (int s = 0; s < steps; ++s) {
    // step s has landed: this thread's copies, then everyone's; the barrier
    // also says every warpgroup is done with step s - 1's products
    wg_cp_async_wait<STAGES - 2>();
    wg_fence_async_proxy();
    __syncthreads();
    const uint32_t stage = ring + st * STAGE_BYTES;
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint64_t da = wg_desc(stage + hf * A_BYTES + wg * 64 * K5T_ROW);
      const uint64_t db = wg_desc(stage + 2 * A_BYTES + hf * B_BYTES);
#pragma unroll
      for (int kk = 0; kk < K5T_HALF / 16; ++kk)  // 32 bytes of K a product
        wg_mma_m64k16<K5T_BN>(acc, da + 2 * kk, db + 2 * kk, hf + kk > 0);
    }
    wg_commit();
    // while the products run: step s + STAGES - 1 into the stage step s - 1
    // has left
    load_next(st == 0 ? STAGES - 1 : st - 1);
    wg_wait<0>();
    wg_fence_acc(acc);
    wg_promote(sum, acc);
    st = st + 1 == STAGES ? 0 : st + 1;
  }

  // epilogue: bias, activation, one rounding, into a staging tile in the
  // ring (every product is done, the copy groups still open are empty).
  // Fragment layout of m64n128: thread (warp, lane) of the warpgroup holds
  // rows warp * 16 + lane / 4 (+ 8), columns nb * 8 + (lane % 4) * 2 (+ 1).
  wg_cp_async_wait<0>();
  __syncthreads();
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row_a = wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
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
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(
          ring_ptr + (row_a + hr * 8) * K5T_C_ROW + col * 2) = pair;
    }
  }
  __syncthreads();
  // whole output rows leave in 16-byte pieces: 16 threads a row
  const bool vec = cout % 8 == 0;  // rows of y start on 16-byte boundaries
#pragma unroll
  for (int it = 0; it < BM * 16 / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int row = idx >> 4, piece = idx & 15;
    const int m = m0 + row;
    const int n = n0 + piece * 8;
    if (m < m_total && n < cout) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          ring_ptr + row * K5T_C_ROW + piece * 16);
      bf16_bits* out = y + (long long)m * cout + n;
      if (vec) {
        *reinterpret_cast<uint4*>(out) = v;
      } else {
        const bf16_bits* e = reinterpret_cast<const bf16_bits*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (n + q < cout) out[q] = e[q];
      }
    }
  }
}
