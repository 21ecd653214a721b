// K4: packed YOLO head decode fused with the 1x1 head conv, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_decode.py ::
// decode_packed_head_fused_pallas (body _decode_packed_fused_kernel). Input
// is the PRE-head activation x (B, gy, gx, Cin), channels-last with channel
// stride 1, and the head conv's weights w (Cout, Cin) row-major (the port's
// channels_last OIHW buffer of a 1x1 conv, viewed 2-D) with a float32 bias.
// For every cell it computes the head row h = x_row . w^T + bias (float32
// sums) and feeds h to the shared decode body (decode_common.cuh), writing
// K1's 8-float records at payload[b, head_offset + a*gy*gx + cell]. The head
// map itself never reaches device memory.
//
// What bounds it on the H100: for yolov3 at 416, batch 8, the three heads
// read about 20 MB of bf16 pre-head activations and weights and write
// 2.7 MB of records (6.9 us at 3.35 TB/s), against 4.94 GFLOP (5 us at the
// 989 TFLOP/s bf16 rate): the work sits at the card's ridge, so neither
// bound leaves room for a kernel that wastes either. Two kernels, chosen by
// the operands' type in the C entry:
//
// bf16: decode_fused_head_mma_kernel below, a 1x1 implicit GEMM on the
// tensor cores (wgmma, wgmma_common.cuh) with the decode as its epilogue.
// M = B*gy*gx cells tiled linearly, K = Cin, both operands K-major as they
// lie in memory (a cell's channels, a weight row), bf16 from device memory
// to the tensor cores. The decode needs a whole anchor's 5 + C channels in
// one block, so a block takes BM cells x ONE anchor: its N is 5 + C padded
// (to a multiple of 32, up to 128; to a multiple of 64 above), weight rows
// a*(5+C) .. + 5+C, the padded rows zero-filled by the copy's source size 0
// (as are rows past M). Grid: ceil(M / BM) x anchors, the anchors of one
// tile side by side so that they find its x rows in L2. BM / 64 warpgroups
// each own 64 rows (two more for N above 128, each owning half the
// columns); a K step is 128 channels, a ring of three steps keeps two in
// flight, and the steps' sums are added in float32 on the CUDA cores
// (wg_promote: the bar on scores is 1e-5 absolute). Epilogue: sum + bias
// staged as a BM x N float32 tile in the freed ring; then G = 2 (or 4)
// adjacent lanes decode one cell (k1_decode_anchor_group<G>, K1's no-FMA
// float order), G times fewer issue slots per record than K1's warp per
// cell, and store its 32-byte record in 16- (8-) byte pieces: a warp writes
// whole runs of consecutive records. The wrapper's plan (ops/cuda_decode.py
// :: plan_fused_tiles) picks the tile rows BM (64 or 128) and, where the
// whole K fits two steps (Cin <= 256), a build for two resident blocks a
// multiprocessor (MINB = 2: a two-step ring, 128 registers a thread), so
// that one block's fill and decode overlap the other's products. What holds
// it back (PERF.md) is latency, not a rate: the 13x13 and 26x26 heads run
// 66 and 129 blocks of 8 and 4 dependent K steps on 132 multiprocessors,
// one wave whose fill, drain and epilogue nothing overlaps; at 52x52 each
// block has two steps, so its fill and its decode are most of its time.
//
// float32: decode_fused_head_kernel below, on the CUDA cores (TF32 would
// miss the float32 bar). One block of 256 threads takes K4_ROWS = 32
// consecutive cells (rows of the flattened B*gy*gx x Cin map). Thread t
// owns output channels t, t+256, ... (K4_CPT of them) for all 32 cells, so
// it keeps 32*K4_CPT float32 accumulators in registers. The reduction runs
// in Cin chunks of K4_KC = 32: the block stages the x chunk (32 cells x 32
// channels, coalesced rows) and the w chunk, transposed to [k][cout] so
// each thread reads its own channel conflict-free, in shared memory; every
// thread then reads the x values as 16-byte broadcasts. Products accumulate
// with __fmaf_rn (one rounding per multiply-add; the -fmad=false build flag
// does not touch the intrinsic) in sequential Cin order. After the loop the
// accumulators plus bias go to a shared (32 x Cout) tile that aliases the
// staging buffers, and the block's 8 warps run the shared decode epilogue on
// it, one cell at a time. It is bound by its shared-memory operand traffic
// and leaves multiprocessors idle at the 13x13 head (43 blocks).

#include "decode_common.cuh"
#include "wgmma_common.cuh"

#define K4_THREADS 256
#define K4_ROWS 32
#define K4_KC 32
#define K4_XS (K4_KC + 4)  // x row stride: 16-byte aligned, spreads banks

struct SharedRow {
  const float* row;
  __device__ __forceinline__ float operator()(int c) const { return row[c]; }
};

template <typename T, int CPT>
__global__ void __launch_bounds__(K4_THREADS)
decode_fused_head_kernel(const T* __restrict__ x, long long sb, long long sy,
                         long long sx, const T* __restrict__ w,
                         const float* __restrict__ bias, int batch, int gy,
                         int gx, int cin, int n_anchors, int n_classes,
                         AnchorSet anchors, float stride, float prob_thresh,
                         int head_offset, int n_total,
                         float* __restrict__ payload) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int per = 5 + n_classes;
  const int cout = n_anchors * per;
  const int ws_stride = CPT * K4_THREADS + 1;  // odd: conflict-free transpose
  const int cells = gy * gx;
  const long long n_rows = (long long)batch * cells;
  const long long row0 = (long long)blockIdx.x * K4_ROWS;
  float* xs = smem;                      // [K4_ROWS][K4_XS]
  float* ws = smem + K4_ROWS * K4_XS;    // [K4_KC][ws_stride]

  float acc[CPT][K4_ROWS];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int r = 0; r < K4_ROWS; ++r) acc[j][r] = 0.0f;

  for (int k0 = 0; k0 < cin; k0 += K4_KC) {
    // x chunk: consecutive threads read consecutive channels of one cell
    for (int i = tid; i < K4_ROWS * K4_KC; i += K4_THREADS) {
      const int r = i / K4_KC, k = i - r * K4_KC;
      const long long g = row0 + r;
      float v = 0.0f;
      if (g < n_rows) {
        const int b = (int)(g / cells);
        const int cell = (int)(g - (long long)b * cells);
        const int yy = cell / gx, xx = cell - (cell / gx) * gx;
        v = k1_ldg(x + b * sb + yy * sy + xx * sx + k0 + k);
      }
      xs[r * K4_XS + k] = v;
    }
    // w chunk, transposed to ws[k][c]; channels >= cout stay unread
    for (int i = tid; i < cout * K4_KC; i += K4_THREADS) {
      const int c = i / K4_KC, k = i - c * K4_KC;
      ws[k * ws_stride + c] = k1_ldg(w + (long long)c * cin + k0 + k);
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < K4_KC; k += 4) {
      float wv[CPT][4];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[j][q] = ws[(k + q) * ws_stride + j * K4_THREADS + tid];
#pragma unroll
      for (int r = 0; r < K4_ROWS; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * K4_XS + k);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = acc[j][r];
          a = __fmaf_rn(xv.x, wv[j][0], a);
          a = __fmaf_rn(xv.y, wv[j][1], a);
          a = __fmaf_rn(xv.z, wv[j][2], a);
          a = __fmaf_rn(xv.w, wv[j][3], a);
          acc[j][r] = a;
        }
      }
    }
    __syncthreads();
  }

  // head tile = acc + bias, in shared memory over the staging buffers
  const int hs_stride = cout + 1;
  float* hs = smem;  // [K4_ROWS][hs_stride]
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = j * K4_THREADS + tid;
    if (c < cout) {
      const float bv = bias[c];
#pragma unroll
      for (int r = 0; r < K4_ROWS; ++r) hs[r * hs_stride + c] = acc[j][r] + bv;
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int r = tid >> 5; r < K4_ROWS; r += K4_THREADS / 32) {
    const long long g = row0 + r;
    if (g >= n_rows) break;  // uniform across the warp
    const int b = (int)(g / cells);
    const int cell = (int)(g - (long long)b * cells);
    const int y = cell / gx, xcol = cell - (cell / gx) * gx;
    const SharedRow load{hs + r * hs_stride};
    for (int a = 0; a < n_anchors; ++a) {
      const K1Record rec = k1_decode_anchor(
          load, a * per, n_classes, lane, xcol, y, stride, anchors.wh[2 * a],
          anchors.wh[2 * a + 1], prob_thresh);
      const int cand = head_offset + a * cells + cell;
      k1_store_packed(rec, lane, cand,
                      payload + ((long long)b * n_total + cand) * 8);
    }
  }
}

template <typename T, int CPT>
static int launch_fused(const void* x, long long sb, long long sy,
                        long long sx, const void* w, const float* bias,
                        int batch, int gy, int gx, int cin, int n_anchors,
                        int n_classes, const AnchorSet& anchors, float stride,
                        float prob_thresh, int head_offset, int n_total,
                        float* payload, cudaStream_t s) {
  const int cout = n_anchors * (5 + n_classes);
  const size_t staging =
      (size_t)(K4_ROWS * K4_XS + K4_KC * (CPT * K4_THREADS + 1)) *
      sizeof(float);
  const size_t tile = (size_t)K4_ROWS * (cout + 1) * sizeof(float);
  const size_t smem = staging > tile ? staging : tile;
  auto kernel = decode_fused_head_kernel<T, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * gy * gx;
  const unsigned blocks = (unsigned)((rows + K4_ROWS - 1) / K4_ROWS);
  kernel<<<blocks, K4_THREADS, smem, s>>>(
      (const T*)x, sb, sy, sx, (const T*)w, bias, batch, gy, gx, cin,
      n_anchors, n_classes, anchors, stride, prob_thresh, head_offset,
      n_total, payload);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_cpt(int cpt, const void* x, long long sb, long long sy,
                        long long sx, const void* w, const float* bias,
                        int batch, int gy, int gx, int cin, int n_anchors,
                        int n_classes, const AnchorSet& anchors, float stride,
                        float prob_thresh, int head_offset, int n_total,
                        float* payload, cudaStream_t s) {
#define K4_CASE(N)                                                          \
  case N:                                                                   \
    return launch_fused<T, N>(x, sb, sy, sx, w, bias, batch, gy, gx, cin,   \
                              n_anchors, n_classes, anchors, stride,        \
                              prob_thresh, head_offset, n_total, payload, s);
  switch (cpt) {
    K4_CASE(1)
    K4_CASE(2)
    K4_CASE(3)
    K4_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K4_CASE
}

// ---------------------------------------------------------------- bf16

#define K4T_BK 128  // channels of a K step: two tiles of 64

// a stage: the two A tiles (bm rows each), then the two B tiles (np rows)
__host__ __device__ constexpr uint32_t k4t_stage_bytes(int bm, int np) {
  return 2u * (uint32_t)(bm + np) * WG_ROW;
}
// dynamic shared memory of a block with `stages` steps in the ring: slack to
// reach a 1,024-byte boundary, then the ring
__host__ __device__ constexpr uint32_t k4t_smem_bytes(int bm, int np,
                                                      int stages) {
  return 1024u + stages * k4t_stage_bytes(bm, np);
}
// steps in the ring: two for two resident blocks a multiprocessor (MINB =
// 2), else three where they fit the 227 KB a block may have (a deeper ring
// measured no faster at Cin 1,024 and 512: PERF.md)
__host__ __device__ constexpr int k4t_stages(int bm, int np, int minb) {
  return minb == 2 || k4t_smem_bytes(bm, np, 3) > 232448 ? 2 : 3;
}

// MINB = 2: two blocks share a multiprocessor (registers capped at 128 a
// thread, two steps in the ring), so that one block's fill and epilogue
// overlap the other's products; the plan takes it where the whole K fits
// the two steps
template <int BM, int N, int WN, int MINB>
__global__ void __launch_bounds__(BM * 2 * WN, MINB)
decode_fused_head_mma_kernel(const bf16_bits* __restrict__ x, long long sb,
                             long long sy, long long sx,
                             const bf16_bits* __restrict__ w,
                             const float* __restrict__ bias, int batch,
                             int gy, int gx, int cin, int n_anchors,
                             int n_classes, AnchorSet anchors, float stride,
                             float prob_thresh, int head_offset, int n_total,
                             float* __restrict__ payload) {
  constexpr int NP = N * WN;           // columns of the tile: >= 5 + C
  constexpr int THREADS = BM * 2 * WN;  // (BM / 64) x WN warpgroups
  constexpr int G = THREADS / BM;       // lanes decoding one cell: 2 or 4
  constexpr int RPP = THREADS / 8;      // tile rows one pass of copies covers
  constexpr int A_IT = BM / RPP;        // copies per thread per tile: A
  constexpr int B_IT = NP / RPP;        //                              B
  constexpr uint32_t A_BYTES = BM * WG_ROW;
  constexpr uint32_t B_BYTES = NP * WG_ROW;
  constexpr uint32_t STAGE_BYTES = k4t_stage_bytes(BM, NP);
  constexpr int STAGES = k4t_stages(BM, NP, MINB);
  constexpr int S = NP + G;  // staged row stride in floats: S % 32 == G, so
                             // the G lanes of 32 / G cells hit 32 banks
  constexpr int R = N / 2;   // accumulators a thread
  static_assert(NP % RPP == 0 && BM % RPP == 0 && RPP % 8 == 0, "copies");
  static_assert(BM * S * 4 <= STAGES * STAGE_BYTES, "the staged tile fits");
  static_assert(MINB * (k4t_smem_bytes(BM, NP, STAGES) + 1024) <= 233472,
                "MINB blocks fit the multiprocessor's 228 KB (1 KB of each "
                "block's is the system's)");

  extern __shared__ unsigned char k4t_smem[];
  const uint32_t raw = wg_smem_u32(k4t_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = k4t_smem + (ring - raw);

  const int tid = threadIdx.x;
  const int per = 5 + n_classes;
  const int cells = gy * gx;
  const int m_total = batch * cells;  // the C entry keeps it under 2^31
  const int a = blockIdx.x % n_anchors;
  const int m0 = (blockIdx.x / n_anchors) * BM;

  // this thread's copies: 16-byte chunk j of rows r0, r0 + RPP, ... of the A
  // tiles (cells) and of the B tiles (the anchor's weight rows). RPP % 8 ==
  // 0, so the swizzle term r & 7 is the same for all of them.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t row_off =
      (uint32_t)r0 * WG_ROW + (uint32_t)((j ^ (r0 & 7)) << 4);
  const bf16_bits* a_src[A_IT];
  uint32_t a_ok = 0;  // bit i: row r0 + i * RPP lies below M
#pragma unroll
  for (int i = 0; i < A_IT; ++i) {
    const int gm = m0 + r0 + i * RPP;
    a_src[i] = x;
    if (gm < m_total) {
      const int pb = gm / cells;
      const int rem = gm - pb * cells;
      const int py = rem / gx;
      const int px = rem - py * gx;
      a_src[i] = x + pb * sb + py * sy + px * sx + j * 8;
      a_ok |= 1u << i;
    }
  }
  const bf16_bits* b_src = w + ((long long)a * per + r0) * cin + j * 8;

  // load_next copies the next K step into stage `st` as one cp.async group;
  // past the last step an empty group keeps the count of groups in step
  // with the loop
  const int steps = cin / K4T_BK;
  int ld_step = 0;
  auto load_next = [&](int st) {
    if (ld_step < steps) {
      const uint32_t stage = ring + st * STAGE_BYTES;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = ld_step * K4T_BK + hf * WG_HALF;
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
          const bool ok = (a_ok >> i) & 1u;
          wg_cp_async16(stage + hf * A_BYTES + row_off + i * RPP * WG_ROW,
                        ok ? a_src[i] + c0 : x, ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
          const bool ok = r0 + i * RPP < per;
          wg_cp_async16(
              stage + 2 * A_BYTES + hf * B_BYTES + row_off + i * RPP * WG_ROW,
              ok ? b_src + (long long)i * RPP * cin + c0 : w, ok ? 16 : 0);
        }
      }
      ++ld_step;
    }
    wg_cp_async_commit();
  };

  // `acc` restarts at every K step; the steps are added in `sum`
  float acc[R];
  float sum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = sum[i] = 0.0f;

  const int wgi = tid >> 7;         // warpgroup
  const int wm = wgi % (BM / 64);   // its rows: wm * 64 .. + 63
  const int wn = wgi / (BM / 64);   // its columns: wn * N .. + N - 1

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
      const uint64_t da = wg_desc(stage + hf * A_BYTES + wm * 64 * WG_ROW);
      const uint64_t db =
          wg_desc(stage + 2 * A_BYTES + hf * B_BYTES + wn * N * WG_ROW);
#pragma unroll
      for (int kk = 0; kk < WG_HALF / 16; ++kk)  // 32 bytes of K a product
        wg_mma_m64k16<N>(acc, da + 2 * kk, db + 2 * kk, hf + kk > 0);
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

  // epilogue: sum + bias into a BM x S float32 tile in the ring (every
  // product is done, the copy groups still open are empty)
  wg_cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(ring_ptr);
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row_a = wm * 64 + warp * 16 + (lane >> 2);
  const int col0 = wn * N + (lane & 3) * 2;
  const float* abias = bias + a * per;  // columns past 5 + C: no bias
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    const int col = col0 + nb * 8;
    const float b0 = col < per ? __ldg(abias + col) : 0.0f;
    const float b1 = col + 1 < per ? __ldg(abias + col + 1) : 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(tile + (row_a + hr * 8) * S + col) =
          make_float2(sum[nb * 4 + hr * 2] + b0, sum[nb * 4 + hr * 2 + 1] + b1);
  }
  __syncthreads();

  // G adjacent lanes decode one cell; rows past M decode their zero-filled
  // products (every lane takes part in the shuffles) and store nothing
  const int r = tid / G, jg = tid % G;
  const int g = m0 + r;
  int pb = 0, cell = 0;
  if (g < m_total) {
    pb = g / cells;
    cell = g - pb * cells;
  }
  const int y = cell / gx, xcol = cell - (cell / gx) * gx;
  const K1Record rec = k1_decode_anchor_group<G>(
      SharedRow{tile + r * S}, 0, n_classes, jg, xcol, y, stride,
      anchors.wh[2 * a], anchors.wh[2 * a + 1], prob_thresh);
  if (g < m_total) {
    constexpr int P = 8 / G;  // floats of the record this lane stores
    const int cand = head_offset + a * cells + cell;
    float v[P];
#pragma unroll
    for (int q = 0; q < P; ++q) v[q] = k1_record_lane(rec, jg * P + q, cand);
    float* out = payload + ((long long)pb * n_total + cand) * 8 + jg * P;
    if constexpr (P == 4)
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  }
}

template <int BM, int N, int WN, int MINB>
static int launch_mma(const void* x, long long sb, long long sy, long long sx,
                      const void* w, const float* bias, int batch, int gy,
                      int gx, int cin, int n_anchors, int n_classes,
                      const AnchorSet& anchors, float stride,
                      float prob_thresh, int head_offset, int n_total,
                      float* payload, cudaStream_t s) {
  constexpr int NP = N * WN;
  constexpr int SMEM =
      (int)k4t_smem_bytes(BM, NP, k4t_stages(BM, NP, MINB));
  auto kernel = decode_fused_head_mma_kernel<BM, N, WN, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)  // all of the 256 KB that shared memory may have
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)batch * gy * gx + BM - 1) / BM;
  kernel<<<(unsigned)(tiles * n_anchors), BM * 2 * WN, SMEM, s>>>(
      (const bf16_bits*)x, sb, sy, sx, (const bf16_bits*)w, bias, batch, gy,
      gx, cin, n_anchors, n_classes, anchors, stride, prob_thresh,
      head_offset, n_total, payload);
  return (int)cudaGetLastError();
}

// C entry (ctypes). x: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) pre-head
// activation addressed as x[b * sb + y * sy + xcol * sx + channel], channel
// stride 1; w: the same type, (n_anchors * (5 + n_classes), cin) row-major;
// bias: float32 (n_anchors * (5 + n_classes)); anchors_wh: host array of 2 *
// n_anchors floats; payload: device float32 (batch, n_total, 8), contiguous,
// filled at [head_offset, head_offset + n_anchors * gy * gx). float32: cin
// a multiple of K4_KC and the head at most 4 * K4_THREADS channels,
// block_m = n_tile = 0. bf16: cin a multiple of 128, x's batch, row and
// pixel strides multiples of 8 elements and x, w 16-byte aligned, the tile
// (block_m, n_tile, resident) of ops/cuda_decode.py :: plan_fused_tiles:
// block_m 64 or 128, n_tile in {32, 64, 96, 128} (64 only above 128: 192,
// 256) and at least 5 + n_classes, resident 2 (blocks a multiprocessor)
// only for cin <= 256 and block_m + n_tile <= 224, else 1. Launches on
// `stream`, allocates nothing, returns the CUDA error code (0 = success).
extern "C" int yolo_decode_packed_fused_head(
    const void* x, long long sb, long long sy, long long sx, int is_bf16,
    const void* w, const float* bias, int batch, int gy, int gx, int cin,
    int n_anchors, int n_classes, const float* anchors_wh, float stride,
    float prob_thresh, int head_offset, int n_total, int block_m, int n_tile,
    int resident, float* payload, void* stream) {
  const int per = 5 + n_classes;
  const int cout = n_anchors * per;
  if (n_anchors < 1 || n_anchors > K1_MAX_ANCHORS || n_classes < 1 ||
      batch < 1 || gy < 1 || gx < 1 ||
      (long long)batch * gy * gx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  AnchorSet anchors;
  for (int i = 0; i < 2 * n_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {
    const int cpt = (cout + K4_THREADS - 1) / K4_THREADS;
    if (cin < K4_KC || cin % K4_KC != 0 || cpt > 4 || block_m != 0 ||
        n_tile != 0 || resident != 0)
      return (int)cudaErrorInvalidValue;
    return dispatch_cpt<float>(cpt, x, sb, sy, sx, w, bias, batch, gy, gx,
                               cin, n_anchors, n_classes, anchors, stride,
                               prob_thresh, head_offset, n_total, payload, s);
  }
  if (cin < K4T_BK || cin % K4T_BK != 0 || n_tile < per || sb % 8 ||
      sy % 8 || sx % 8 || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
      (resident == 2 && (cin > 2 * K4T_BK || block_m + n_tile > 224)))
    return (int)cudaErrorInvalidValue;
#define K4T_CASE(BM, NP, N, WN, MINB)                                       \
  if (block_m == BM && n_tile == NP && resident == MINB)                    \
    return launch_mma<BM, N, WN, MINB>(x, sb, sy, sx, w, bias, batch, gy,   \
                                       gx, cin, n_anchors, n_classes,       \
                                       anchors, stride, prob_thresh,        \
                                       head_offset, n_total, payload, s);
  K4T_CASE(64, 32, 32, 1, 1)
  K4T_CASE(64, 64, 64, 1, 1)
  K4T_CASE(64, 96, 96, 1, 1)
  K4T_CASE(64, 128, 128, 1, 1)
  K4T_CASE(128, 32, 32, 1, 1)
  K4T_CASE(128, 64, 64, 1, 1)
  K4T_CASE(128, 96, 96, 1, 1)
  K4T_CASE(128, 128, 128, 1, 1)
  K4T_CASE(64, 192, 96, 2, 1)
  K4T_CASE(64, 256, 128, 2, 1)
  K4T_CASE(64, 32, 32, 1, 2)
  K4T_CASE(64, 64, 64, 1, 2)
  K4T_CASE(64, 96, 96, 1, 2)
  K4T_CASE(64, 128, 128, 1, 2)
  K4T_CASE(128, 32, 32, 1, 2)
  K4T_CASE(128, 64, 64, 1, 2)
  K4T_CASE(128, 96, 96, 1, 2)
#undef K4T_CASE
  return (int)cudaErrorInvalidValue;
}
