// The diagnostic tools' kernels (T1, T2, T3a-e), CUDA C++ for sm_90a.
//
// They replace the seven Pallas kernels of the JAX package's tools/:
//   T1  tools/bench_int8_dot.py :: make_dot        -> probe_dot_step_kernel
//   T2  tools/bench_pallas_dot.py :: timed_grid    -> probe_dot_grid_kernel
//   T3a tools/probe_block.py :: probe_int8_dot     -> probe_dot_step_kernel,
//                                                     store mode
//   T3b probe_round  -> probe_round_clip_kernel (16-byte pieces)
//   T3c probe_roll   -> probe_roll_kernel
//   T3d probe_mask   -> probe_mask_kernel (every tile in one launch)
//   T3e probe_epilogue -> probe_epilogue_kernel (no division, 16-byte
//                                               pieces)
// The wrappers, plain versions and launch counts are in ops/cuda_probe.py.
//
// The dots. The TPU kernels hold whole operands in VMEM and run one MXU
// dot. T1's product (M, K) . (K, N) is tiled 64 x 64 over thread blocks of
// four warps (one warpgroup) and multiplied with one of four cores:
//   CORE_MMA_S8     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//   CORE_DP4A_S8    __dp4a on the integer lanes (K6's core until its
//                   redesign)
//   CORE_WGMMA_S8   wgmma.mma_async m64n64k32.s32.s8.s8 (what K6 runs)
//   CORE_WGMMA_BF16 wgmma.mma_async m64n64k16.f32.bf16.bf16
// The mma.sync and __dp4a cores stage 64 bytes of K of both operands per
// step through registers into padded shared rows (the next step's loads in
// flight while this step multiplies) and multiply them in hand-written
// fragments (inline PTX). The wgmma cores take the building blocks of
// wgmma_common.cuh: the (M, K) operand, K-major as it is, goes by cp.async
// into the 128-byte swizzle, a ring of three steps of 128 bytes of K; the
// (K, N) operand keeps the register path, where the carry is added and it
// is transposed to [N][K] (int8 wgmma takes only K-major operands) into the
// same swizzle; one step is four products of 32 bytes of K. The (K, N)
// operand's transpose is a 4 x 4 byte or 2 x 2 halfword transpose in
// registers, so that four / two consecutive K elements of a column share a
// 32-bit word. Ragged M, N and K are zero-filled in the loads (cp.async
// with source size 0 for the (M, K) operand). T2 (bf16 only) runs all three
// of its products on wgmma with its (K, N) operand MN-major as it lies (the
// transpose flag): probe_dot_grid_kernel below.
//
// As in the TPU kernels every element of the product is consumed: the tile's
// sums, rounded to bf16, go through two small projections p1 (8, M) and
// p2 (N, 128), out = bf16(p1 . bf16(acc)) . p2, float32 sums. p1 runs on the
// tensor cores in both kernels (mma.sync in T1, wgmma in T2); p2 does so in
// T2, while in T1 it is a scalar loop on the CUDA cores of the block that
// finishes a column of tiles (its operand exists only once the M tiles are
// summed). T1 keeps its per-step
// dependency: a runtime carry (about 0) is added to the small (K, N) operand
// while it is staged, and each step moves the carry by 1e-24 of its result,
// so step s + 1 cannot start before step s has finished and no step repeats
// another's work. Store mode (T3a, and the bare product of the timing split)
// writes the tile's sums instead.
//
// T1 spreads ONE product over the card (grid = M tiles x N tiles), because a
// step is one dot and the next step waits for it; the projections' sums over
// M tiles and N tiles are finished by the last block to arrive (a counter per
// N tile column, then one for the grid; sums in tile order, so the result
// does not depend on the blocks' order). T2's TPU grid is `grid` sequential
// steps with nothing carried between them: here they are `grid` independent
// blocks, each computing one whole product with its projections, because a
// card is full only with at least 132 blocks in flight and nothing orders
// the steps; the two-size differential of the tool then reads the time the
// whole card needs per product.
//
// What bounds them: T1 / T2 / T3a operations at large shapes, launch and the
// serial finish at the small ones (bytes never: the operands stay in L2);
// T3b-e bytes, and at their sizes the launch. T2 reads both operands once per
// tile from L2, 2 M K N (1 / BN + 1 / BM) bytes a product.
//
// Ablation macro (yolov3_tpu_torch/tools/ablate_phases.py):
// -DT2_SKIP_PROJECT keeps T2's products and drops both projections (each
// thread sums its tile's values and stores that): the bare product's time.
//
// Float contract: as everywhere in this library (-fmad=false, rounding half
// to even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_int8_common.cuh"
#include "wgmma_common.cuh"

#define PD_BM 64
#define PD_BN 64
#define PD_BKB 64           // bytes of K staged per step
#define PD_LDS 80           // shared row stride in bytes: conflict-free frags
#define PD_THREADS 128
#define PD_CS_LD 72         // bf16 elements per row of the consumed tile
#define CORE_MMA_S8 0
#define CORE_DP4A_S8 1
#define CORE_WGMMA_S8 3
#define CORE_WGMMA_BF16 4
#define MODE_STORE 0
#define MODE_PROJECT 1
#define PW_STAGES 3         // wgmma cores: K steps in the ring
#define PW_STEP 128         // bytes of K a step: one tile row
#define PW_TILE (PD_BM * WG_ROW)  // bytes of one operand tile of a step
// dynamic shared memory of the wgmma cores: slack to a 1,024-byte boundary,
// then per stage the (M, K) tile and the [N][K] tile
#define PW_SMEM (1024 + PW_STAGES * 2 * PW_TILE)

template <int CORE>
__host__ __device__ constexpr bool is_wgmma_core() {
  return CORE == CORE_WGMMA_S8 || CORE == CORE_WGMMA_BF16;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned short bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ float bf16_float(unsigned short bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// One staged step of both operands in registers: the loads of step i + 1 are
// started before the products of step i, so their latency hides behind them.
struct StageRegs {
  int4 a[2];        // lhs: two 16-byte chunks per thread
  uint32_t b[8];    // rhs: eight 32-bit words per thread
  uint32_t valid;   // bit i: b[i] lies inside (K, N); zero-fill stays zero
};

// Load rows m0 .. m0+63, K bytes kb0 .. kb0+63 of the row-major int8 lhs
// (16-byte loads) and K rows k0 .., columns n0 .. n0+63 of the row-major
// rhs (32-bit words of 4 columns; a thread takes 4 consecutive K rows of its
// columns, which stage_store transposes); zero past M, N or K.
template <int CORE>
__device__ __forceinline__ void stage_load(StageRegs& r,
                                           const unsigned char* lhs,
                                           const unsigned char* rhs, int m,
                                           int k, int n, int m0, int n0,
                                           int k0, int tid) {
  constexpr int ROWS = 4;           // K rows that share a 32-bit word
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * PD_THREADS, row = c >> 2, ch = c & 3;
    r.a[i] = make_int4(0, 0, 0, 0);
    if (m0 + row < m && k0 + ch * 16 < k)
      r.a[i] = __ldg(reinterpret_cast<const int4*>(
          lhs + (long long)(m0 + row) * k + k0 + ch * 16));
  }
  r.valid = 0;
#pragma unroll
  for (int i = 0; i < 8 / ROWS; ++i) {
    const int item = tid + i * PD_THREADS;
    const int kg = item / (PD_BN / ROWS), nw = item % (PD_BN / ROWS);
    const int col = n0 + nw * ROWS;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int krow = k0 + kg * ROWS + rr;
      r.b[i * ROWS + rr] = 0;
      if (krow < k && col < n) {
        r.b[i * ROWS + rr] = __ldg(reinterpret_cast<const uint32_t*>(
            rhs + (long long)krow * n + col));
        r.valid |= 1u << (i * ROWS + rr);
      }
    }
  }
}

// Registers -> shared memory: As[row][PD_LDS] as loaded; the rhs words moved
// by the carry (byte-wise with wrap-around) and transposed into
// Bs[col][PD_LDS], K contiguous, so that a 32-bit word of a column holds the
// 4 consecutive K elements an mma B fragment (and __dp4a) wants.
template <int CORE>
__device__ __forceinline__ void stage_store(const StageRegs& r,
                                            unsigned char* As,
                                            unsigned char* Bs, float carry,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * PD_THREADS, row = c >> 2, ch = c & 3;
    *reinterpret_cast<int4*>(As + row * PD_LDS + ch * 16) = r.a[i];
  }
  const uint32_t c4 = (uint32_t)((int)carry & 0xff) * 0x01010101u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int item = tid + i * PD_THREADS, kg = item >> 4, nw = item & 15;
    uint32_t w[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      w[rr] = (r.valid >> (i * 4 + rr)) & 1u ? __vadd4(r.b[i * 4 + rr], c4)
                                             : 0u;
    // 4 x 4 byte transpose: word j of the result holds byte j of w[0..3]
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    unsigned char* dst = Bs + (nw * 4) * PD_LDS + kg * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + PD_LDS) =
        __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * PD_LDS) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * PD_LDS) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

// One 64 x 64 tile of the product for the block's (m0, n0): the sums land in
// `acc` in the core's own register layout (see tile_coords).
template <int CORE, typename AccT>
__device__ __forceinline__ void tile_product(
    AccT (&acc)[8][4], unsigned char* As, unsigned char* Bs, const void* lhs,
    const void* rhs, int m, int k, int n, int m0, int n0, float carry,
    int tid) {
  constexpr int KSTEP = PD_BKB;  // K elements per staged step
  const unsigned char* lhs8 = static_cast<const unsigned char*>(lhs);
  const unsigned char* rhs8 = static_cast<const unsigned char*>(rhs);
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  StageRegs regs;
  stage_load<CORE>(regs, lhs8, rhs8, m, k, n, m0, n0, 0, tid);
  for (int k0 = 0; k0 < k; k0 += KSTEP) {
    stage_store<CORE>(regs, As, Bs, carry, tid);
    __syncthreads();
    if (k0 + KSTEP < k)
      stage_load<CORE>(regs, lhs8, rhs8, m, k, n, m0, n0, k0 + KSTEP, tid);
    if constexpr (CORE == CORE_DP4A_S8) {
      // thread (ty, tx): rows ty + 8 i, columns tx + 16 j
      const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 4
      for (int kw = 0; kw < PD_BKB / 4; ++kw) {
        int a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = (int)lds32(As + (ty + 8 * i) * PD_LDS + kw * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = (int)lds32(Bs + (tx + 16 * j) * PD_LDS + kw * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    } else {
      // warp (wm, wn): rows wm*32 + mi*16, columns wn*32 + ni*8; a k-step
      // of the mma is 32 bytes of K
#pragma unroll
      for (int ks = 0; ks < PD_BKB / 32; ++ks) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* base =
              As + (wm * 32 + mi * 16 + g) * PD_LDS + ks * 32 + t * 4;
          a[mi][0] = lds32(base);
          a[mi][1] = lds32(base + 8 * PD_LDS);
          a[mi][2] = lds32(base + 16);
          a[mi][3] = lds32(base + 8 * PD_LDS + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const unsigned char* base =
              Bs + (wn * 32 + ni * 8 + g) * PD_LDS + ks * 32 + t * 4;
          b[ni][0] = lds32(base);
          b[ni][1] = lds32(base + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            mma_s8(acc[mi * 4 + ni], a[mi], b[ni]);
          }
      }
    }
    __syncthreads();
  }
}

// The wgmma cores' (K, N) operand for one step (128 bytes of K) in
// registers: 32 groups of 4 (int8) / 2 (bf16) consecutive K rows x 16 / 32
// words of 4 / 2 columns; a thread takes 4 / 8 (group, word) items.
struct WgRegs {
  uint32_t b[16];
  uint32_t valid;  // bit i: b[i] lies inside (K, N); zero-fill stays zero
};

template <int ES>
__device__ __forceinline__ void wg_rhs_load(WgRegs& r,
                                            const unsigned char* rhs, int k,
                                            int n, int n0, int k0, int tid) {
  constexpr int ROWS = 4 / ES;          // K rows that share a 32-bit word
  constexpr int WORDS = PD_BN / ROWS;   // words of a K row of the tile
  constexpr int ITEMS = 16 / ROWS;      // (group, word) items a thread
  r.valid = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int item = tid + i * PD_THREADS;
    const int kg = item / WORDS, nw = item % WORDS;
    const int col = n0 + nw * ROWS;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int krow = k0 + kg * ROWS + rr;
      r.b[i * ROWS + rr] = 0;
      if (krow < k && col < n) {
        r.b[i * ROWS + rr] = __ldg(reinterpret_cast<const uint32_t*>(
            rhs + ((long long)krow * n + col) * ES));
        r.valid |= 1u << (i * ROWS + rr);
      }
    }
  }
}

// byte offset of K byte kb of row r in a tile with the 128-byte swizzle
__device__ __forceinline__ uint32_t wg_swizzled(int r, int kb) {
  return (uint32_t)(r * WG_ROW + ((((kb >> 4) ^ r) & 7) << 4) + (kb & 15));
}

// Registers -> the step's [N][K] tile: the words moved by the carry (int8:
// byte-wise with wrap-around; bf16: float32 sum rounded to bf16 once, as in
// stage_store) and transposed so that a 32-bit word holds 4 / 2 consecutive
// K elements of one column.
template <int ES>
__device__ __forceinline__ void wg_rhs_store(const WgRegs& r,
                                             unsigned char* bs, float carry,
                                             int tid) {
  if constexpr (ES == 2) {
    const float cb = bf16_float(bf16_bits(carry));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int item = tid + i * PD_THREADS, kg = item >> 5, nw = item & 31;
      uint32_t w[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const uint32_t v = r.b[i * 2 + rr];
        const uint32_t lo = bf16_bits(__uint_as_float(v << 16) + cb);
        const uint32_t hi = bf16_bits(__uint_as_float(v & 0xffff0000u) + cb);
        w[rr] = (r.valid >> (i * 2 + rr)) & 1u ? (lo | (hi << 16)) : 0u;
      }
      *reinterpret_cast<uint32_t*>(bs + wg_swizzled(nw * 2, kg * 4)) =
          __byte_perm(w[0], w[1], 0x5410);
      *reinterpret_cast<uint32_t*>(bs + wg_swizzled(nw * 2 + 1, kg * 4)) =
          __byte_perm(w[0], w[1], 0x7632);
    }
  } else {
    const uint32_t c4 = (uint32_t)((int)carry & 0xff) * 0x01010101u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int item = tid + i * PD_THREADS, kg = item >> 4, nw = item & 15;
      uint32_t w[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        w[rr] = (r.valid >> (i * 4 + rr)) & 1u ? __vadd4(r.b[i * 4 + rr], c4)
                                               : 0u;
      // 4 x 4 byte transpose: word j of the result holds byte j of w[0..3]
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t t[4] = {__byte_perm(lo01, lo23, 0x5410),
                             __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410),
                             __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(bs + wg_swizzled(nw * 4 + j, kg * 4)) =
            t[j];
    }
  }
}

// One 64 x 64 tile of the product on wgmma: acc (this warpgroup's m64n64
// fragment, viewed as [8][4]) = lhs[m0 .., :] . (rhs[:, n0 ..] + carry).
template <int CORE, typename AccT>
__device__ __forceinline__ void tile_product_wgmma(
    AccT (&acc)[8][4], const void* lhs, const void* rhs, int m, int k, int n,
    int m0, int n0, float carry, int tid) {
  constexpr int ES = CORE == CORE_WGMMA_BF16 ? 2 : 1;
  constexpr int KSTEP = PW_STEP / ES;  // K elements per step
  extern __shared__ unsigned char pw_smem[];
  const uint32_t raw = wg_smem_u32(pw_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = pw_smem + (ring - raw);
  const unsigned char* lhs8 = static_cast<const unsigned char*>(lhs);
  const unsigned char* rhs8 = static_cast<const unsigned char*>(rhs);
  const long long kbytes = (long long)k * ES;
  const int steps = (k + KSTEP - 1) / KSTEP;
  AccT(&d)[32] = *reinterpret_cast<AccT(*)[32]>(&acc[0][0]);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0;

  // the (M, K) tile of the next step into stage `st` as one cp.async group
  // (an empty group past the last step keeps the count in step)
  int ld = 0;
  auto load_lhs = [&](int st) {
    if (ld < steps) {
      const uint32_t dst = ring + st * 2 * PW_TILE;
      const long long kb0 = (long long)ld * PW_STEP;
#pragma unroll
      for (int i = 0; i < PD_BM * 8 / PD_THREADS; ++i) {
        const int c = tid + i * PD_THREADS, row = c >> 3, ch = c & 7;
        const bool ok = m0 + row < m && kb0 + ch * 16 < kbytes;
        wg_cp_async16(dst + row * WG_ROW + ((ch ^ (row & 7)) << 4),
                      ok ? lhs8 + (long long)(m0 + row) * kbytes + kb0 + ch * 16
                         : lhs8,
                      ok ? 16 : 0);
      }
      ++ld;
    }
    wg_cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < PW_STAGES - 1; ++st) load_lhs(st);
  WgRegs regs;
  wg_rhs_load<ES>(regs, rhs8, k, n, n0, 0, tid);
  int st = 0;
  for (int s = 0; s < steps; ++s) {
    // stage st was last read by step s - PW_STAGES, which every warp has
    // finished: it passed the barrier of step s - 1 after waiting for it
    const uint32_t stage = ring + st * 2 * PW_TILE;
    wg_rhs_store<ES>(regs, ring_ptr + (stage - ring) + PW_TILE, carry, tid);
    if (s + 1 < steps)
      wg_rhs_load<ES>(regs, rhs8, k, n, n0, (s + 1) * KSTEP, tid);
    wg_cp_async_wait<PW_STAGES - 2>();
    wg_fence_async_proxy();
    __syncthreads();
    const uint64_t da = wg_desc(stage), db = wg_desc(stage + PW_TILE);
    wg_fence_acc(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < PW_STEP / 32; ++kk) {
      if constexpr (CORE == CORE_WGMMA_S8)
        wg_mma_m64k32_s8<PD_BN>(d, da + 2 * kk, db + 2 * kk, 1);
      else
        wg_mma_m64k16<PD_BN>(d, da + 2 * kk, db + 2 * kk, 1);
    }
    wg_commit();
    // while the products run: the (M, K) tile of step s + PW_STAGES - 1
    // into the stage step s - 1 has left
    load_lhs(st == 0 ? PW_STAGES - 1 : st - 1);
    wg_wait<0>();
    wg_fence_acc(d);
    st = st + 1 == PW_STAGES ? 0 : st + 1;
  }
  wg_cp_async_wait<0>();
}

// Tile-local (row, column) of acc[i / 4][i % 4] in the core's register
// layout.
template <int CORE>
__device__ __forceinline__ void tile_coords(int i, int tid, int* row,
                                            int* col) {
  if constexpr (is_wgmma_core<CORE>()) {
    // wgmma m64n64: warp w holds rows 16 w + lane / 4 (+ 8), columns
    // 8 nb + 2 (lane % 4) (+ 1) in d[4 nb + 2 hr + e] (wgmma_common.cuh)
    const int lane = tid & 31, warp = tid >> 5;
    *row = warp * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
    *col = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
  } else if constexpr (CORE == CORE_DP4A_S8) {
    *row = (tid >> 4) + 8 * (i >> 2);
    *col = (tid & 15) + 16 * (i & 3);
  } else {
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int mi = i >> 4, ni = (i >> 2) & 3, e = i & 3;
    *row = (warp >> 1) * 32 + mi * 16 + g + (e >> 1) * 8;
    *col = (warp & 1) * 32 + ni * 8 + t * 2 + (e & 1);
  }
}

// First projection of the consumed tile on the tensor cores:
// d[j] += p1[:, m0 .. m0+63] . Cs, for the warp's 16 columns (j: 8 each).
// Cs[col][PD_CS_LD] holds bf16(acc) with M contiguous; p1 is (8, M) bf16 in
// device memory, read straight into the A fragment (rows 8-15 are zero).
__device__ __forceinline__ void project_p1(float (&d)[2][4],
                                           const unsigned short* Cs,
                                           const unsigned short* p1, int m,
                                           int m0, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < PD_BM; kk += 16) {
    uint32_t a[4] = {0, 0, 0, 0};
    const int ma = m0 + kk + 2 * t;
    if (ma < m)
      a[0] = __ldg(reinterpret_cast<const uint32_t*>(
          p1 + (long long)g * m + ma));
    if (ma + 8 < m)
      a[2] = __ldg(reinterpret_cast<const uint32_t*>(
          p1 + (long long)g * m + ma + 8));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const unsigned short* base =
          Cs + (warp * 16 + j * 8 + g) * PD_CS_LD + kk + 2 * t;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(base),
                             *reinterpret_cast<const uint32_t*>(base + 8)};
      mma_bf16(d[j], a, b);
    }
  }
}

struct ProbeDot {
  const void* lhs;
  const void* rhs;
  const unsigned short* p1;   // (8, M) bf16
  const unsigned short* p2;   // (N, 128) bf16
  float* carry;               // one float, or null: no shift
  void* out;                  // store: (M, N); project: (8, 128) float32
  float* partial;             // project: (M tiles, 8, N)
  float* partial2;            // project: (N tiles, 8, 128)
  unsigned int* counters;     // project: 1 + N tiles, zero between launches
  int m, k, n;
};

// T1 and T3a: one product spread over the grid (x: M tiles, y: N tiles).
template <int CORE, int MODE, typename AccT>
__global__ void __launch_bounds__(PD_THREADS)
probe_dot_step_kernel(const ProbeDot p) {
  __shared__ __align__(16) unsigned short Cs[PD_BN * PD_CS_LD];
  __shared__ float Pb[8][PD_BN];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int mt = blockIdx.x, nt = blockIdx.y;
  const int m0 = mt * PD_BM, n0 = nt * PD_BN;
  const float carry = p.carry ? *static_cast<volatile float*>(p.carry) : 0.0f;
  AccT acc[8][4];
  if constexpr (is_wgmma_core<CORE>()) {
    tile_product_wgmma<CORE, AccT>(acc, p.lhs, p.rhs, p.m, p.k, p.n, m0, n0,
                                   carry, tid);
  } else {
    __shared__ __align__(16) unsigned char As[PD_BM * PD_LDS];
    __shared__ __align__(16) unsigned char Bs[PD_BN * PD_LDS];
    tile_product<CORE, AccT>(acc, As, Bs, p.lhs, p.rhs, p.m, p.k, p.n, m0,
                             n0, carry, tid);
  }
  if (MODE == MODE_STORE) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int row, col;
      tile_coords<CORE>(i, tid, &row, &col);
      if (m0 + row < p.m && n0 + col < p.n)
        static_cast<AccT*>(p.out)[(long long)(m0 + row) * p.n + n0 + col] =
            acc[i >> 2][i & 3];
    }
    return;
  }
  // ---- consume the tile: bf16(acc) -> Cs, then p1 on the tensor cores
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int row, col;
    tile_coords<CORE>(i, tid, &row, &col);
    Cs[col * PD_CS_LD + row] = bf16_bits((float)acc[i >> 2][i & 3]);
  }
  __syncthreads();
  float d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  project_p1(d, Cs, p.p1, p.m, m0, tid);
  {
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + warp * 16 + j * 8 + 2 * t + e;
        if (col < p.n)
          p.partial[((long long)mt * 8 + g) * p.n + col] = d[j][e];
      }
  }
  // ---- the last block of this column of tiles sums the M tiles
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&p.counters[1 + nt], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = tid; idx < 8 * PD_BN; idx += PD_THREADS) {
    const int r = idx / PD_BN, cn = idx % PD_BN;
    float sum = 0.0f;
    if (n0 + cn < p.n) {
#pragma unroll 8
      for (int i = 0; i < (int)gridDim.x; ++i)
        sum += __ldcg(&p.partial[((long long)i * 8 + r) * p.n + n0 + cn]);
    }
    Pb[r][cn] = bf16_float(bf16_bits(sum));
  }
  __syncthreads();
  {
    // second projection of this column's 64 rows of p2; thread = column
    float o[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 16
    for (int cn = 0; cn < PD_BN; ++cn) {
      // rows of p2 past N meet a zero of Pb: clamp the address only
      const int row = min(n0 + cn, p.n - 1);
      const float w = bf16_float(__ldg(&p.p2[(long long)row * 128 + tid]));
#pragma unroll
      for (int r = 0; r < 8; ++r) o[r] += Pb[r][cn] * w;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      p.partial2[((long long)nt * 8 + r) * 128 + tid] = o[r];
  }
  // ---- the last column sums the N tiles into out and moves the carry
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    p.counters[1 + nt] = 0;
    s_last = atomicAdd(&p.counters[0], 1u) == gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float sum = 0.0f;
    for (int i = 0; i < (int)gridDim.y; ++i)
      sum += __ldcg(&p.partial2[((long long)i * 8 + r) * 128 + tid]);
    static_cast<float*>(p.out)[r * 128 + tid] = sum;
    if (r == 0 && tid == 0 && p.carry) *p.carry = carry + sum * 1e-24f;
  }
  if (tid == 0) p.counters[0] = 0;
}

// ---- T2 on wgmma. A block is one step of the TPU grid: the whole product
// (M, K) . (K, N) with its projections -> out[step] (8, 128) bf16. The tile
// plan (ops/cuda_probe.py :: plan_grid_tiles) picks W warpgroups (BM = 64 W
// rows of the product, one 64-row slab each) and BN columns; the block
// walks the N tiles, and inside each the M tiles:
//
//   product   acc (BM x BN) = lhs[m0.., :] . rhs[:, n0..] on wgmma, K in
//             steps of 64 through a ring of PgTiles::STAGES stages: lhs
//             K-major as it lies, rhs MN-major as it lies (the transpose
//             flag), both by cp.async into the 128-byte swizzle, ragged
//             M, N and K zero-filled (source size 0); the last step issues
//             only the k16 products K reaches
//   proj1     d1^T (BN x 8) += bf16(acc)^T . p1[:, m0..]^T: bf16(acc) goes
//             into the free ring row-major, which is the MN-major A operand
//             of an m64n8k16 product; p1's rows are its K-major B operand
//   proj2     o^T (128 x 8) += p2[n0.., :]^T . bf16(d1)^T once the M tiles
//             are summed: p2's rows, MN-major, by cp.async into the ring;
//             bf16(d1) K-major beside it
//
// so out = bf16(p1 . bf16(acc)) . p2 with float32 sums, every product on
// the tensor cores and no operand transposed in registers. The ring, the
// acc tile and the p2 tile share one region (each is free once the phase
// before it has waited for its products and passed a barrier).

#define PG_STEP 64    // K elements of a ring stage: one 128-byte row
#define PG_ATOM 1024  // bytes of one swizzle atom: eight 128-byte rows

template <int W, int BN>
struct PgTiles {
  static constexpr int BM = 64 * W;
  static constexpr int THREADS = 128 * W;
  static constexpr int A_BYTES = BM * WG_ROW;      // (BM, 64 k), K-major
  static constexpr int B_BYTES = PG_STEP * BN * 2;  // (64 k, BN), MN-major
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = STAGE <= 32768 ? 3 : 2;
  static constexpr int C_BYTES = BM * BN * 2;       // bf16(acc), MN-major
  static constexpr int P2_BYTES = BN * 128 * 2;     // p2's rows, MN-major
  static constexpr int RING =
      STAGES * STAGE > C_BYTES
          ? (STAGES * STAGE > P2_BYTES ? STAGES * STAGE : P2_BYTES)
          : (C_BYTES > P2_BYTES ? C_BYTES : P2_BYTES);
  static constexpr int P1_BYTES = (BM / 64) * PG_ATOM;  // (8, BM), K-major
  static constexpr int D1_BYTES = (BN / 64) * PG_ATOM;  // (8, BN), K-major
  static constexpr int SMEM = 1024 + RING + P1_BYTES + D1_BYTES;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
}

// byte offset of element (row, e) of an 8-row K-major tile of 16-bit
// elements whose row is split into 64-element atoms (p1's and bf16(d1)'s
// tiles: row = i, e = m or n)
__device__ __forceinline__ int pg_kmajor8(int row, int e) {
  return (e >> 6) * PG_ATOM + row * WG_ROW + ((((e >> 3) & 7) ^ row) << 4) +
         (e & 7) * 2;
}

template <int W, int BN>
__global__ void __launch_bounds__(128 * W)
probe_dot_grid_kernel(const unsigned short* lhs, const unsigned short* rhs,
                      const unsigned short* p1, const unsigned short* p2,
                      int m, int k, int n, unsigned short* out) {
  using G = PgTiles<W, BN>;
  constexpr int NH = BN / 128;        // m64n128 products a k16 step
  constexpr int D1B = BN / 64 / W;    // this warpgroup's 64-row blocks of d1^T
  constexpr int OB = 2 / W;           // ... and of o^T
  extern __shared__ unsigned char pg_smem[];
  const uint32_t raw = wg_smem_u32(pg_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = pg_smem + (ring - raw);
  const uint32_t p1s = ring + G::RING, d1s = p1s + G::P1_BYTES;
  unsigned char* p1s_ptr = ring_ptr + G::RING;
  unsigned char* d1s_ptr = p1s_ptr + G::P1_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int steps = (k + PG_STEP - 1) / PG_STEP;
  const int last_k16 = ((k - (steps - 1) * PG_STEP) + 15) >> 4;

  float o[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#ifdef T2_SKIP_PROJECT
  float keep = 0.0f;
#endif
  for (int n0 = 0; n0 < n; n0 += BN) {
    float d1[D1B][4];
#pragma unroll
    for (int j = 0; j < D1B; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d1[j][e] = 0.0f;
    for (int m0 = 0; m0 < m; m0 += G::BM) {
      // ---- the product: acc = lhs[m0.., :] . rhs[:, n0..]
      float acc[NH][64];
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
      int ld = 0;
      auto load = [&](int st) {
        if (ld < steps) {
          const uint32_t sa = ring + st * G::STAGE, sb = sa + G::A_BYTES;
          const int k0 = ld * PG_STEP;
          for (int c = tid; c < G::BM * 8; c += G::THREADS) {
            const int row = c >> 3, ch = c & 7;
            const bool ok = m0 + row < m && k0 + ch * 8 < k;
            wg_cp_async16(sa + row * WG_ROW + ((ch ^ (row & 7)) << 4),
                          ok ? lhs + (long long)(m0 + row) * k + k0 + ch * 8
                             : lhs,
                          ok ? 16 : 0);
          }
          // rhs row k0 + kr, columns n0 + 8 cn ..: atom (cn / 8, kr / 8)
          // at (gn * 8 + kg) * PG_ATOM, row kr % 8
          for (int c = tid; c < PG_STEP * (BN / 8); c += G::THREADS) {
            const int kr = c / (BN / 8), cn = c % (BN / 8);
            const int r = kr & 7, ch = cn & 7;
            const bool ok = k0 + kr < k && n0 + cn * 8 < n;
            wg_cp_async16(sb + ((cn >> 3) * 8 + (kr >> 3)) * PG_ATOM +
                              r * WG_ROW + ((ch ^ r) << 4),
                          ok ? rhs + (long long)(k0 + kr) * n + n0 + cn * 8
                             : rhs,
                          ok ? 16 : 0);
          }
          ++ld;
        }
        wg_cp_async_commit();
      };
#pragma unroll
      for (int st = 0; st < G::STAGES - 1; ++st) load(st);
      int st = 0;
      for (int s = 0; s < steps; ++s) {
        // stage st was last read by step s - STAGES, which every warpgroup
        // has finished: it passed the barrier of step s - 1 after its wait
        wg_cp_async_wait<G::STAGES - 2>();
        wg_fence_async_proxy();
        __syncthreads();
        const uint32_t sa = ring + st * G::STAGE + wg * 64 * WG_ROW;
        const uint32_t sb = ring + st * G::STAGE + G::A_BYTES;
        const int nk = s + 1 < steps ? PG_STEP / 16 : last_k16;
#pragma unroll
        for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < PG_STEP / 16; ++kk) {
          if (kk < nk) {
#pragma unroll
            for (int h = 0; h < NH; ++h)
              wg_mma_m64k16<128, 0, 1>(
                  acc[h], wg_desc(sa + 32 * kk),
                  wg_desc_mn(sb + (h * 16 + kk * 2) * PG_ATOM, 8 * PG_ATOM,
                             PG_ATOM),
                  1);
          }
        }
        wg_commit();
        // while the products run: the step STAGES - 1 ahead into the stage
        // step s - 1 has left
        load(st == 0 ? G::STAGES - 1 : st - 1);
        wg_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
        st = st + 1 == G::STAGES ? 0 : st + 1;
      }
      wg_cp_async_wait<0>();
      __syncthreads();  // every warpgroup's products are done: the ring is free
#ifdef T2_SKIP_PROJECT
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) keep += acc[h][i];
    }
  }
  if (tid < 1024) out[(long long)blockIdx.x * 1024 + tid] = bf16_bits(keep);
#else
      // ---- bf16(acc) row-major into the ring: element (ml, nl) in atom
      // (nl / 64, ml / 8) at (gn * BM / 8 + km) * PG_ATOM, row ml % 8
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int nb = 0; nb < 16; ++nb)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int ml = 64 * wg + 16 * warp + (lane >> 2) + 8 * hr;
            const int nl = 128 * h + 8 * nb + 2 * (lane & 3);
            const int r = ml & 7;
            *reinterpret_cast<uint32_t*>(
                ring_ptr + ((nl >> 6) * (G::BM / 8) + (ml >> 3)) * PG_ATOM +
                r * WG_ROW + ((((nl >> 3) & 7) ^ r) << 4) + (nl & 7) * 2) =
                pack_bf16x2(acc[h][nb * 4 + hr * 2],
                            acc[h][nb * 4 + hr * 2 + 1]);
          }
      // p1[:, m0 .. m0 + BM) as 8 K-major rows (zero past M; M is even)
      for (int w = tid; w < 4 * G::BM; w += G::THREADS) {
        const int i = w / (G::BM / 2), mm = 2 * (w % (G::BM / 2));
        const uint32_t v =
            m0 + mm < m ? __ldg(reinterpret_cast<const uint32_t*>(
                              p1 + (long long)i * m + m0 + mm))
                        : 0u;
        *reinterpret_cast<uint32_t*>(p1s_ptr + pg_kmajor8(i, mm)) = v;
      }
      wg_fence_async_proxy();
      __syncthreads();
      // ---- proj1: d1^T (n x 8) += bf16(acc)^T (n x m) . p1^T (m x 8)
#pragma unroll
      for (int j = 0; j < D1B; ++j) wg_fence_acc(d1[j]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::BM / 16; ++kk) {
        const uint64_t db = wg_desc(p1s + (kk >> 2) * PG_ATOM + 32 * (kk & 3));
#pragma unroll
        for (int j = 0; j < D1B; ++j)
          wg_mma_m64k16<8, 1, 0>(
              d1[j],
              wg_desc_mn(ring + ((wg + j * W) * (G::BM / 8) + 2 * kk) *
                                    PG_ATOM,
                         (G::BM / 8) * PG_ATOM, PG_ATOM),
              db, 1);
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int j = 0; j < D1B; ++j) wg_fence_acc(d1[j]);
      __syncthreads();  // the acc and p1 tiles are read
    }
    // ---- bf16(d1) as 8 K-major rows, p2[n0 .. n0 + BN) MN-major into the
    // ring: row nn in atom (j / 64, nn / 8) at (gj * BN / 8 + kn) * PG_ATOM
#pragma unroll
    for (int j = 0; j < D1B; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nl = 64 * (wg + j * W) + 16 * warp + (lane >> 2) + 8 * hr;
          *reinterpret_cast<unsigned short*>(
              d1s_ptr + pg_kmajor8(2 * (lane & 3) + e, nl)) =
              bf16_bits(d1[j][hr * 2 + e]);
        }
    for (int q = tid; q < BN * 16; q += G::THREADS) {
      const int nn = q >> 4, cj = q & 15, r = nn & 7;
      const bool ok = n0 + nn < n;
      wg_cp_async16(ring + ((cj >> 3) * (BN / 8) + (nn >> 3)) * PG_ATOM +
                        r * WG_ROW + (((cj & 7) ^ r) << 4),
                    ok ? p2 + (long long)(n0 + nn) * 128 + cj * 8 : p2,
                    ok ? 16 : 0);
    }
    wg_cp_async_commit();
    wg_cp_async_wait<0>();
    wg_fence_async_proxy();
    __syncthreads();
    // ---- proj2: o^T (128 x 8) += p2^T (128 x n) . bf16(d1)^T (n x 8)
#pragma unroll
    for (int j = 0; j < OB; ++j) wg_fence_acc(o[j]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = wg_desc(d1s + (kk >> 2) * PG_ATOM + 32 * (kk & 3));
#pragma unroll
      for (int j = 0; j < OB; ++j)
        wg_mma_m64k16<8, 1, 0>(
            o[j],
            wg_desc_mn(ring + ((wg + j * W) * (BN / 8) + 2 * kk) * PG_ATOM,
                       (BN / 8) * PG_ATOM, PG_ATOM),
            db, 1);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < OB; ++j) wg_fence_acc(o[j]);
    __syncthreads();  // the p2 and bf16(d1) tiles are read
  }
  // ---- out[step] (8, 128) = bf16(o); o^T's rows are out's columns
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 64 * (wg + j * W) + 16 * warp + (lane >> 2) + 8 * hr;
        out[((long long)blockIdx.x * 8 + 2 * (lane & 3) + e) * 128 + col] =
            bf16_bits(o[j][hr * 2 + e]);
      }
#endif
}

// T3b: clip(round-half-even(x), -127, 127), K6's requantizer at scale 1
// (K6's own k6_round_clip). Bound by bytes: each float read once and written
// once. A thread takes a 16-byte piece: a float4 load, four k6_round_clip and
// a float4 store; ops/cuda_probe.plan_elementwise gives one piece a thread
// (one block at the tool's 1,152 floats), and a grid-stride walk takes the
// pieces past the grid it is given. One piece a thread, not a grid of one
// wave walking ten pieces a thread: blocks that retire and start at their
// own times overlap one block's math with another's loads, where a wave
// walking in step waits for its loads, then computes, all at once (slower
// at K6's size on the H100, the more so for T3e's longer math; PERF.md
// keeps the times). The n % 4 tail, or every element when an operand is
// off the 16-byte grid (VEC false), takes the same walk a float at a time.
// Counts and indexes are 64-bit.
#define PE_THREADS 512
#define PE_MAX_ELEMENTS (1LL << 60)  // 4-byte elements: byte offsets in int64

template <bool VEC>
__global__ void __launch_bounds__(PE_THREADS)
    probe_round_clip_kernel(const float* __restrict__ x,
                            float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long pieces = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long p = t; p < pieces; p += stride) {
      const float4 v = x4[p];
      o4[p] = make_float4(k6_round_clip(v.x), k6_round_clip(v.y),
                          k6_round_clip(v.z), k6_round_clip(v.w));
    }
    tail = pieces << 2;
  }
  for (long long i = tail + t; i < n; i += stride) out[i] = k6_round_clip(x[i]);
}

// T3c: both circular shifts of an int8 (rows, lanes) plane along its rows,
// int8 -> float32 -> int8 as the TPU probe. out: (2, planes, rows, lanes),
// the shift by +1, then by -1. Bound by bytes (each input byte read once,
// two written), and at the tool's (10, 48, 128) by the launch.
//
// A block takes 2^rows_lg rows of one plane and a chunk of 2^pieces_lg
// 16-byte pieces of lanes (at most 512 bytes); ops/cuda_probe.plan_roll picks
// both (8 rows and 8 pieces at the tool's shape: 60 blocks of 64 threads).
// It stages its rows and the wrap-around row above and below them AS INT8 in
// shared memory, 16 bytes a cp.async (wg_cp_async16, as K6 stages its halo
// slab, whose row taps it then reads back from shared memory), so shared
// memory is bounded by the chunk, never by the plane. Thread (row j, piece
// q) then reads its piece of staged rows j and j + 2, takes each byte through
// float32 and back in registers with K6's carries (k6_small_float,
// k6_level_int), and writes one 16-byte piece of each output. No division
// but one per block. Lanes that are no multiple of 16, or operands off the
// 16-byte grid, take the same walk a byte at a time (VEC false).
#define PR_PIECE 16
#define PR_SMEM 5120  // (rows + 2) x pieces x 16 at rows x pieces <= 256

__device__ __forceinline__ uint32_t probe_roundtrip4(uint32_t word) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int v = (int8_t)(word >> (8 * e));
    out |= (uint32_t)(k6_level_int(k6_small_float(v)) & 0xff) << (8 * e);
  }
  return out;
}

template <bool VEC>
__global__ void probe_roll_kernel(const int8_t* __restrict__ x,
                                  int8_t* __restrict__ out, int planes,
                                  int rows, int lanes, int row_chunks,
                                  int pieces_lg, int rows_lg) {
  __shared__ __align__(16) int8_t tile[PR_SMEM];
  const int nrows = 1 << rows_lg, stride = PR_PIECE << pieces_lg;
  const int plane = blockIdx.x / row_chunks;
  const int r0 = (blockIdx.x - plane * row_chunks) << rows_lg;
  const int here = min(nrows, rows - r0);
  const int q = threadIdx.x & ((1 << pieces_lg) - 1);
  const int j = threadIdx.x >> pieces_lg;
  const int lane = blockIdx.y * stride + q * PR_PIECE;
  const int width = min(PR_PIECE, lanes - lane);  // <= 0: past the lanes
  const long long base = (long long)plane * rows * lanes + lane;
  // rows r0 - 1 .. r0 + here, wrapped, as staged rows 0 .. here + 1
  for (int s = j; s < here + 2; s += nrows) {
    int r = r0 - 1 + s;
    r = r < 0 ? r + rows : (r >= rows ? r - rows : r);
    const int8_t* src = x + base + (long long)r * lanes;
    int8_t* dst = tile + s * stride + q * PR_PIECE;
    if (VEC) {
      if (width > 0) wg_cp_async16(wg_smem_u32(dst), src, 16);
    } else {
      for (int e = 0; e < width; ++e) dst[e] = src[e];
    }
  }
  if (VEC) {
    wg_cp_async_commit();
    wg_cp_async_wait<0>();
  }
  __syncthreads();
  if (j >= here || width <= 0) return;
  const int8_t* up = tile + j * stride + q * PR_PIECE;  // row r - 1
  const int8_t* down = up + 2 * stride;                  // row r + 1
  int8_t* o_up = out + base + (long long)(r0 + j) * lanes;
  int8_t* o_down = o_up + (long long)planes * rows * lanes;
  if (VEC) {
    const uint4 a = *reinterpret_cast<const uint4*>(up);
    const uint4 b = *reinterpret_cast<const uint4*>(down);
    *reinterpret_cast<uint4*>(o_up) =
        make_uint4(probe_roundtrip4(a.x), probe_roundtrip4(a.y),
                   probe_roundtrip4(a.z), probe_roundtrip4(a.w));
    *reinterpret_cast<uint4*>(o_down) =
        make_uint4(probe_roundtrip4(b.x), probe_roundtrip4(b.y),
                   probe_roundtrip4(b.z), probe_roundtrip4(b.w));
  } else {
    for (int e = 0; e < width; ++e) {
      o_up[e] = (int8_t)k6_level_int(k6_small_float(up[e]));
      o_down[e] = (int8_t)k6_level_int(k6_small_float(down[e]));
    }
  }
}

// T3d: K6's image-edge mask of one or more row tiles of a slab `ws` pixels
// wide, tile t's first slab row at image row row0[t], each slab pixel's
// validity written across cp lanes as int32: out (tiles, rows, cp). Bound by
// the bytes it writes, and at the tool's three tiles by the launch. ONE
// launch for every tile (the grid's y); a warp takes a slab pixel, evaluates
// K6's own k6_slab_valid for it once (a value uniform over the warp, no
// division by cp), and writes its cp lanes as 16-byte int4 stores, a 512-byte
// row a store at the tool's cp = 128 (cp no multiple of 4: int stores).
#define PM_WARPS 8
#define PM_MAX_TILES 64

struct ProbeMaskTiles {
  int row0[PM_MAX_TILES];
};

__global__ void probe_mask_kernel(int* __restrict__ out, int rows, int cp,
                                  int ws, int h, int w,
                                  const ProbeMaskTiles tiles) {
  const int lane = threadIdx.x & 31;
  const int flat = blockIdx.x * PM_WARPS + (threadIdx.x >> 5);
  if (flat >= rows) return;
  const int v = k6_slab_valid(flat, ws, tiles.row0[blockIdx.y], 0, h, w);
  int* dst = out + ((long long)blockIdx.y * rows + flat) * cp;
  if (cp % 4 == 0) {
    const int4 v4 = make_int4(v, v, v, v);
    for (int c = lane; c < cp / 4; c += 32)
      reinterpret_cast<int4*>(dst)[c] = v4;
  } else {
    for (int c = lane; c < cp; c += 32) dst[c] = v;
  }
}

// T3e: K6's conv epilogue on an int32 (rows, cols) sum: * deq + b -> leaky
// -> requantize, K6's own k6_dequant_leaky and k6_requant (built with
// -fmad=false: numpy float32's chain bit for bit). Bound by bytes: each sum
// read once, each float written once. No division: a block is PQ_LANES lanes
// x PQ_ROWS rows; lane l of block column bx owns the four columns from
// 4 (PQ_LANES bx + l) (grid x: chunks of 128 columns) and loads their deq
// and b into registers; row thread ty of block row by takes row
// by * PQ_ROWS + ty and, past the grid's y, the rows a stride of
// gridDim.y * PQ_ROWS on (ops/cuda_probe.plan_epilogue gives one row a
// thread up to the grid's limit, as T3b gives one piece). A row is one int4
// load and one float4 store a lane (VEC), or four scalar ones when cols % 4
// != 0 or an operand is off the 16-byte grid. Indexes are 64-bit.
#define PQ_LANES 32
#define PQ_ROWS 8

template <bool VEC>
__global__ void __launch_bounds__(PQ_LANES* PQ_ROWS)
    probe_epilogue_kernel(const int* __restrict__ acc,
                          const float* __restrict__ deq,
                          const float* __restrict__ bias, float inv,
                          float* __restrict__ out, long long rows,
                          long long cols) {
  const long long c0 = ((long long)blockIdx.x * PQ_LANES + threadIdx.x) * 4;
  if (c0 >= cols) return;
  const int w = (int)min(4LL, cols - c0);
  float d[4], b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] = e < w ? deq[c0 + e] : 0.0f;
    b[e] = e < w ? bias[c0 + e] : 0.0f;
  }
  const long long step = (long long)gridDim.y * PQ_ROWS;
  for (long long r = (long long)blockIdx.y * PQ_ROWS + threadIdx.y; r < rows;
       r += step) {
    const long long i = r * cols + c0;
    if (VEC) {
      const int4 a = *reinterpret_cast<const int4*>(acc + i);
      *reinterpret_cast<float4*>(out + i) =
          make_float4(k6_requant(k6_dequant_leaky(a.x, d[0], b[0]), inv),
                      k6_requant(k6_dequant_leaky(a.y, d[1], b[1]), inv),
                      k6_requant(k6_dequant_leaky(a.z, d[2], b[2]), inv),
                      k6_requant(k6_dequant_leaky(a.w, d[3], b[3]), inv));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < w)
          out[i + e] = k6_requant(k6_dequant_leaky(acc[i + e], d[e], b[e]), inv);
    }
  }
}

template <int CORE, int MODE, typename AccT>
static int launch_dot_steps(const ProbeDot& p, int steps, cudaStream_t s) {
  const dim3 grid((p.m + PD_BM - 1) / PD_BM, (p.n + PD_BN - 1) / PD_BN);
  int smem = 0;
  if constexpr (is_wgmma_core<CORE>()) {
    static bool allowed[WG_MAX_DEVICES] = {};  // the ring is above 48 KB
    const cudaError_t e =
        wg_allow_smem(probe_dot_step_kernel<CORE, MODE, AccT>, PW_SMEM,
                      allowed);
    if (e != cudaSuccess) return (int)e;
    smem = PW_SMEM;
  }
  for (int i = 0; i < steps; ++i)
    probe_dot_step_kernel<CORE, MODE, AccT><<<grid, PD_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// C entries (ctypes). All launch on `stream`, allocate nothing and return
// cudaGetLastError().

// T1 / T3a. lhs (m, k), rhs (k, n) row-major, int8 (core 0 mma.sync, 1
// __dp4a, 3 wgmma) or bf16 (core 4 wgmma), 16-byte aligned, k bytes per row
// a multiple of 16, n a multiple of 8. mode 0: out (m, n) int32 / float32 =
// lhs . (rhs + carry). mode 1: p1 (8, m) and p2 (n, 128) bf16, m even; out
// (8, 128) float32; partial (m tiles, 8, n) and partial2 (n tiles, 8, 128)
// float32 scratch; counters (1 + n tiles) uint32, zero; `steps` dependent
// launches, each moving *carry.
extern "C" int yolo_probe_dot(const void* lhs, const void* rhs, const void* p1,
                              const void* p2, float* carry, int m, int k, int n,
                              int core, int mode, void* out, float* partial,
                              float* partial2, void* counters, int steps,
                              void* stream) {
  const int es = core == CORE_WGMMA_BF16 ? 2 : 1;
  if (m < 1 || k < 1 || n < 8 || n % 8 || ((long long)k * es) % 16 ||
      steps < 1 || (n + PD_BN - 1) / PD_BN > 65535 ||
      (mode == MODE_PROJECT && (m % 2 || !p1 || !p2 || !partial || !partial2 ||
                                !counters)))
    return (int)cudaErrorInvalidValue;
  ProbeDot p;
  p.lhs = lhs;
  p.rhs = rhs;
  p.p1 = static_cast<const unsigned short*>(p1);
  p.p2 = static_cast<const unsigned short*>(p2);
  p.carry = carry;
  p.out = out;
  p.partial = partial;
  p.partial2 = partial2;
  p.counters = static_cast<unsigned int*>(counters);
  p.m = m;
  p.k = k;
  p.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_STORE) {
    switch (core) {
      case CORE_MMA_S8:
        return launch_dot_steps<CORE_MMA_S8, MODE_STORE, int>(p, steps, s);
      case CORE_DP4A_S8:
        return launch_dot_steps<CORE_DP4A_S8, MODE_STORE, int>(p, steps, s);
      case CORE_WGMMA_S8:
        return launch_dot_steps<CORE_WGMMA_S8, MODE_STORE, int>(p, steps, s);
      case CORE_WGMMA_BF16:
        return launch_dot_steps<CORE_WGMMA_BF16, MODE_STORE, float>(p, steps,
                                                                    s);
    }
  } else if (mode == MODE_PROJECT) {
    switch (core) {
      case CORE_MMA_S8:
        return launch_dot_steps<CORE_MMA_S8, MODE_PROJECT, int>(p, steps, s);
      case CORE_DP4A_S8:
        return launch_dot_steps<CORE_DP4A_S8, MODE_PROJECT, int>(p, steps, s);
      case CORE_WGMMA_S8:
        return launch_dot_steps<CORE_WGMMA_S8, MODE_PROJECT, int>(p, steps,
                                                                  s);
      case CORE_WGMMA_BF16:
        return launch_dot_steps<CORE_WGMMA_BF16, MODE_PROJECT, float>(
            p, steps, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int W, int BN>
static int launch_dot_grid(const void* lhs, const void* rhs, const void* p1,
                           const void* p2, int m, int k, int n, int grid,
                           void* out, cudaStream_t s) {
  static bool allowed[WG_MAX_DEVICES] = {};
  const cudaError_t e = wg_allow_smem(probe_dot_grid_kernel<W, BN>,
                                      PgTiles<W, BN>::SMEM, allowed);
  if (e != cudaSuccess) return (int)e;
  probe_dot_grid_kernel<W, BN>
      <<<grid, PgTiles<W, BN>::THREADS, PgTiles<W, BN>::SMEM, s>>>(
          static_cast<const unsigned short*>(lhs),
          static_cast<const unsigned short*>(rhs),
          static_cast<const unsigned short*>(p1),
          static_cast<const unsigned short*>(p2), m, k, n,
          static_cast<unsigned short*>(out));
  return (int)cudaGetLastError();
}

// T2. lhs (m, k), rhs (k, n), p2 (n, 128) bf16, 16-byte aligned; p1 (8, m)
// bf16, 4-byte aligned; k and n multiples of 8, m even; out (grid, 8, 128)
// bf16. (block_m, block_n): the tile plan, (64, 128), (64, 256) or
// (128, 128).
extern "C" int yolo_probe_dot_grid(const void* lhs, const void* rhs,
                                   const void* p1, const void* p2, int m, int k,
                                   int n, int grid, int block_m, int block_n,
                                   void* out, void* stream) {
  if (m < 2 || m % 2 || k < 8 || k % 8 || n < 8 || n % 8 || grid < 1 ||
      reinterpret_cast<uintptr_t>(lhs) % 16 ||
      reinterpret_cast<uintptr_t>(rhs) % 16 ||
      reinterpret_cast<uintptr_t>(p2) % 16 ||
      reinterpret_cast<uintptr_t>(p1) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m == 64 && block_n == 128)
    return launch_dot_grid<1, 128>(lhs, rhs, p1, p2, m, k, n, grid, out, s);
  if (block_m == 64 && block_n == 256)
    return launch_dot_grid<1, 256>(lhs, rhs, p1, p2, m, k, n, grid, out, s);
  if (block_m == 128 && block_n == 128)
    return launch_dot_grid<2, 128>(lhs, rhs, p1, p2, m, k, n, grid, out, s);
  return (int)cudaErrorInvalidValue;
}

static bool off_grid(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// T3b. x, out: n float32 (1 to PE_MAX_ELEMENTS); `blocks` of PE_THREADS
// (ops/cuda_probe.py plan_elementwise); vec: 16-byte pieces, both operands
// 16-byte aligned, else float by float.
extern "C" int yolo_probe_round_clip(const float* x, float* out, long long n,
                                     int blocks, int vec, void* stream) {
  if (n < 1 || n > PE_MAX_ELEMENTS || blocks < 1 ||
      (vec && (off_grid(x) || off_grid(out))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    probe_round_clip_kernel<true><<<blocks, PE_THREADS, 0, s>>>(x, out, n);
  else
    probe_round_clip_kernel<false><<<blocks, PE_THREADS, 0, s>>>(x, out, n);
  return (int)cudaGetLastError();
}

// T3c. x (planes, rows, lanes) int8 contiguous, out (2, planes, rows, lanes);
// blocks of 2^rows_lg rows x 2^pieces_lg 16-byte pieces (ops/cuda_probe.py
// plan_roll); vec: 16-byte pieces, lanes a multiple of 16 and both operands
// 16-byte aligned, else byte by byte.
extern "C" int yolo_probe_roll(const void* x, void* out, int planes, int rows,
                               int lanes, int pieces_lg, int rows_lg, int vec,
                               void* stream) {
  if (planes < 1 || rows < 1 || lanes < 1 || pieces_lg < 0 || pieces_lg > 5 ||
      rows_lg < 0 || rows_lg > 8 ||
      ((1 << rows_lg) + 2) * (PR_PIECE << pieces_lg) > PR_SMEM ||
      (1 << (rows_lg + pieces_lg)) > 256 ||
      (vec && (lanes % PR_PIECE ||
               reinterpret_cast<uintptr_t>(x) % 16 ||
               reinterpret_cast<uintptr_t>(out) % 16)))
    return (int)cudaErrorInvalidValue;
  const int row_chunks = (rows + (1 << rows_lg) - 1) >> rows_lg;
  const long long lane_chunks =
      ((long long)lanes + (PR_PIECE << pieces_lg) - 1) / (PR_PIECE << pieces_lg);
  if ((long long)planes * row_chunks > 0x7fffffff || lane_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(planes * row_chunks), (unsigned)lane_chunks);
  const int threads = 1 << (rows_lg + pieces_lg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* src = static_cast<const int8_t*>(x);
  int8_t* dst = static_cast<int8_t*>(out);
  if (vec)
    probe_roll_kernel<true><<<grid, threads, 0, s>>>(
        src, dst, planes, rows, lanes, row_chunks, pieces_lg, rows_lg);
  else
    probe_roll_kernel<false><<<grid, threads, 0, s>>>(
        src, dst, planes, rows, lanes, row_chunks, pieces_lg, rows_lg);
  return (int)cudaGetLastError();
}

// T3d. out (tiles, rows, cp) int32, 16-byte aligned; row0s: `tiles` (1 to
// PM_MAX_TILES) first image rows, a host array passed in the launch's
// parameters.
extern "C" int yolo_probe_masks(int* out, int rows, int cp, int ws,
                                const int* row0s, int tiles, int h, int w,
                                void* stream) {
  if (rows < 1 || cp < 1 || ws < 1 || tiles < 1 || tiles > PM_MAX_TILES ||
      !row0s || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  ProbeMaskTiles t = {};
  for (int i = 0; i < tiles; ++i) t.row0[i] = row0s[i];
  const dim3 grid((unsigned)((rows + PM_WARPS - 1) / PM_WARPS), tiles);
  probe_mask_kernel<<<grid, 32 * PM_WARPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(out, rows, cp, ws,
                                                           h, w, t);
  return (int)cudaGetLastError();
}

// T3e. acc int32 and out float32 (rows, cols), at most PE_MAX_ELEMENTS;
// deq, bias (cols,) float32; a (grid_x, grid_y) grid of PQ_LANES x PQ_ROWS
// blocks (ops/cuda_probe.py plan_epilogue), grid_x covering the columns;
// vec: cols % 4 == 0 and acc, out 16-byte aligned, else scalar.
extern "C" int yolo_probe_epilogue(const int* acc, const float* deq,
                                   const float* bias, float inv, float* out,
                                   long long rows, long long cols, int grid_x,
                                   int grid_y, int vec, void* stream) {
  if (rows < 1 || cols < 1 || cols > PE_MAX_ELEMENTS / rows || grid_x < 1 ||
      (long long)grid_x * PQ_LANES * 4 < cols || grid_y < 1 ||
      grid_y > 65535 ||
      (vec && (cols % 4 || off_grid(acc) || off_grid(out))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const dim3 block(PQ_LANES, PQ_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    probe_epilogue_kernel<true><<<grid, block, 0, s>>>(acc, deq, bias, inv,
                                                       out, rows, cols);
  else
    probe_epilogue_kernel<false><<<grid, block, 0, s>>>(acc, deq, bias, inv,
                                                        out, rows, cols);
  return (int)cudaGetLastError();
}
