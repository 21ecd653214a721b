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
// the operands' type in the C entry, with one design:
//
// a 1x1 implicit GEMM on the tensor cores (wgmma, wgmma_common.cuh) with
// the decode as its epilogue. M = B*gy*gx cells tiled linearly, K = Cin,
// both operands K-major as they lie in memory (a cell's channels, a weight
// row). The decode needs a whole anchor's 5 + C channels in one block, so a
// block takes BM cells x ONE anchor: its N is 5 + C padded (to a multiple
// of 32, up to 128; to a multiple of 64 above, up to 256, the widest wgmma
// N), weight rows a*(5+C) .. + 5+C, the padded rows zero-filled by the
// copy's source size 0 (as are rows past M). Above 256 columns (more than
// 251 classes: Open Images' 601) the block runs them in pieces of 256, one
// K loop each over the same cells: the first piece carries the box and
// objectness columns, every piece a share of the classes, and each cell's
// running class max and first argmax pass from piece to piece (an equal
// logit of a later piece keeps the earlier index, the reference's first
// argmax). Grid: ceil(M / BM) x anchors, the anchors of one tile side by
// side so that they find its x rows in L2. BM / 64 warpgroups each own 64
// rows (two more for N above 128, each owning half the columns); each K
// step's sums are added in float32 on the CUDA cores (wg_promote: the bar
// on scores is 1e-5 absolute). Epilogue of a piece (k4_piece_epilogue):
// sum + bias staged as a BM x N float32 tile in the freed ring, then G = 2
// (or 4) adjacent lanes scan one cell's class columns; after the last
// piece (k4_store_record) they finish the cell's record
// (k1_decode_finish<G>, K1's no-FMA float order), G times fewer issue
// slots per record than K1's warp per cell, and store its 32-byte record
// in 16- (8-) byte pieces: a warp writes whole runs of consecutive
// records. The wrapper's plan (ops/cuda_decode.py :: plan_fused_tiles)
// picks the tile rows BM (64 or 128).
//
// bf16: decode_fused_head_mma_kernel, bf16 from device memory to the tensor
// cores, a K step of 128 channels, a ring of three steps keeping two in
// flight; where the whole K fits two steps (Cin <= 256) the plan takes a
// build for two resident blocks a multiprocessor (MINB = 2: a two-step
// ring, 128 registers a thread), so that one block's fill and decode
// overlap the other's products. What holds it back (PERF.md) is latency,
// not a rate: the 13x13 and 26x26 heads run 66 and 129 blocks of 8 and 4
// dependent K steps on 132 multiprocessors, one wave whose fill, drain and
// epilogue nothing overlaps; at 52x52 each block has two steps, so its fill
// and its decode are most of its time.
//
// float32: decode_fused_head_tf32x3_kernel, split TF32 (3xTF32,
// wgmma_common.cuh :: wg_gemm_tf32x3): three TF32 products per product
// (hi * hi + hi * lo + lo * hi) hold the float32 score bar of 1e-5, which
// one TF32 pass misses. A K step is 32 channels (one 128-byte row of
// float32); the pre-head rows are split in registers, the weight rows
// arrive split (hi and lo, made once per weight tensor by the wrapper:
// ops/tf32.py :: tf32_operands), and a ring of four steps (three where 5 +
// C is above 192) keeps the rest in flight while one is multiplied; one
// resident block a multiprocessor. Its floor: 3 x 4.94 GFLOP at the 495
// TFLOP/s TF32 rate, 0.030 ms (the bytes, about 36 MB of float32, need
// 0.011 ms); the same latency as the bf16 kernel's, now over four times as
// many K steps, is what holds it above that. Inputs are finite (the split
// of an infinity is not).

#include "decode_common.cuh"
#include "wgmma_common.cuh"

// the widest tile (the widest wgmma N): an anchor's columns above it run
// in pieces of it
#define K4_MAX_N 256

struct SharedRow {
  const float* row;
  __device__ __forceinline__ float operator()(int c) const { return row[c]; }
};

// One cell's decode state across the pieces of its anchor's columns: this
// lane's running class max and first argmax and, in the widest tile (the
// only one that runs pieces), the box and objectness logits (columns 0 ..
// 4 of the first piece, held in registers and read by selects).
struct K4Cell {
  float tx, ty, tw, th, obj;
  float best;
  int best_i;
  __device__ __forceinline__ float operator()(int c) const {
    return c == 0 ? tx : c == 1 ? ty : c == 2 ? tw : c == 3 ? th : obj;
  }
};

// The epilogue of one piece of both kernels, after its K loop (every
// product done, the ring free): the piece's columns c_base .. c_base +
// ncol - 1 of the anchor, sum + bias, into a BM x S float32 tile in the
// ring, S = NP + G (S % 32 == G, so the G lanes of 32 / G cells hit 32
// banks); then the G adjacent lanes of each cell scan its class columns of
// the piece into `cell` (the first piece also gives the box columns). The
// caller syncs before the ring is filled again.
template <int BM, int N, int WN>
__device__ __forceinline__ void k4_piece_epilogue(
    const float (&sum)[N / 2], unsigned char* ring_ptr, int wm, int wn,
    const float* __restrict__ pbias, int c_base, int ncol, K4Cell& cell) {
  constexpr int NP = N * WN;
  constexpr int THREADS = BM * 2 * WN;
  constexpr int G = THREADS / BM;  // lanes decoding one cell: 2 or 4
  constexpr int S = NP + G;
  const int tid = threadIdx.x;
  float* tile = reinterpret_cast<float*>(ring_ptr);
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row_a = wm * 64 + warp * 16 + (lane >> 2);
  const int col0 = wn * N + (lane & 3) * 2;
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    const int col = col0 + nb * 8;  // columns past the piece's: no bias
    const float b0 = col < ncol ? __ldg(pbias + col) : 0.0f;
    const float b1 = col + 1 < ncol ? __ldg(pbias + col + 1) : 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(tile + (row_a + hr * 8) * S + col) =
          make_float2(sum[nb * 4 + hr * 2] + b0, sum[nb * 4 + hr * 2 + 1] + b1);
  }
  __syncthreads();

  const float* row = tile + (tid / G) * S;
  if (NP == K4_MAX_N && c_base == 0) {  // a later piece overwrites the tile
    cell.tx = row[0];
    cell.ty = row[1];
    cell.tw = row[2];
    cell.th = row[3];
    cell.obj = row[4];
  }
  // class k lies in column k + 5 - c_base of the piece
  k1_scan_classes<G>(SharedRow{row}, 5 - c_base, c_base > 5 ? c_base - 5 : 0,
                     c_base + ncol - 5, tid % G, cell.best, cell.best_i);
}

// After the last piece: the group's class max, the record, and its store.
// The box and objectness columns come from `cell` where the tile may have
// held pieces (NP = K4_MAX_N), else from the one piece's tile, still in
// the ring. Rows past M decode their zero-filled products (every lane takes
// part in the shuffles) and store nothing.
template <int BM, int N, int WN>
__device__ __forceinline__ void k4_store_record(
    K4Cell& cell, const unsigned char* ring_ptr, int m0, int a, int m_total,
    int gy, int gx, const AnchorSet& anchors, float stride,
    float prob_thresh, int head_offset, int n_total,
    float* __restrict__ payload) {
  constexpr int NP = N * WN;
  constexpr int THREADS = BM * 2 * WN;
  constexpr int G = THREADS / BM;
  const int tid = threadIdx.x;
  const int cells = gy * gx;
  const int r = tid / G, jg = tid % G;
  const int g = m0 + r;
  int pb = 0, c = 0;
  if (g < m_total) {
    pb = g / cells;
    c = g - pb * cells;
  }
  const int y = c / gx, xcol = c - (c / gx) * gx;
  k1_group_best<G>(cell.best, cell.best_i);
  K1Record rec;
  if constexpr (NP == K4_MAX_N)
    rec = k1_decode_finish<G>(cell, 0, cell.best, cell.best_i, jg, xcol, y,
                              stride, anchors.wh[2 * a],
                              anchors.wh[2 * a + 1], prob_thresh);
  else
    rec = k1_decode_finish<G>(
        SharedRow{reinterpret_cast<const float*>(ring_ptr) + r * (NP + G)},
        0, cell.best, cell.best_i, jg, xcol, y, stride, anchors.wh[2 * a],
        anchors.wh[2 * a + 1], prob_thresh);
  if (g < m_total) {
    constexpr int P = 8 / G;  // floats of the record this lane stores
    const int cand = head_offset + a * cells + c;
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
  const int steps = cin / K4T_BK;

  const int wgi = tid >> 7;         // warpgroup
  const int wm = wgi % (BM / 64);   // its rows: wm * 64 .. + 63
  const int wn = wgi / (BM / 64);   // its columns: wn * N .. + N - 1

  // the anchor's 5 + C columns in pieces of NP: the first holds the box
  // and objectness columns, every piece a share of the classes, whose max
  // and first argmax pass from piece to piece in `cell`
  K4Cell cell;
  cell.best = -INFINITY;
  cell.best_i = n_classes;
  // narrower tiles hold the anchor in one piece (the C entry's check): one
  // trip the compiler sees
  const int span = NP == K4_MAX_N ? per : 1;
  for (int c_base = 0; c_base < span; c_base += NP) {
    // the piece's weight rows: a * per + c_base .. + ncol - 1
    const bf16_bits* b_src =
        w + ((long long)a * per + c_base + r0) * cin + j * 8;
    const int ncol = min(per - c_base, NP);

    // load_next copies the next K step into stage `st` as one cp.async
    // group; past the last step an empty group keeps the count of groups
    // in step with the loop
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
            const bool ok = r0 + i * RPP < ncol;
            wg_cp_async16(stage + 2 * A_BYTES + hf * B_BYTES + row_off +
                              i * RPP * WG_ROW,
                          ok ? b_src + (long long)i * RPP * cin + c0 : w,
                          ok ? 16 : 0);
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

#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) load_next(p);

    int st = 0;  // the stage of step s
    for (int s = 0; s < steps; ++s) {
      // step s has landed: this thread's copies, then everyone's; the
      // barrier also says every warpgroup is done with step s - 1's
      // products
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
      // while the products run: step s + STAGES - 1 into the stage step
      // s - 1 has left
      load_next(st == 0 ? STAGES - 1 : st - 1);
      wg_wait<0>();
      wg_fence_acc(acc);
      wg_promote(sum, acc);
      st = st + 1 == STAGES ? 0 : st + 1;
    }

    // the copy groups still open are empty
    wg_cp_async_wait<0>();
    __syncthreads();
    k4_piece_epilogue<BM, N, WN>(sum, ring_ptr, wm, wn,
                                 bias + a * per + c_base, c_base, ncol, cell);
    // every lane has read the tile before the next piece fills the ring
    __syncthreads();
  }
  k4_store_record<BM, N, WN>(cell, ring_ptr, m0, a, m_total, gy, gx, anchors,
                             stride, prob_thresh, head_offset, n_total,
                             payload);
}

// ---------------------------------------------------------------- float32

// a stage: the A tile (bm rows), the B hi and lo tiles (np rows each), 32
// float32 channels a row
__host__ __device__ constexpr uint32_t k4f_stage_bytes(int bm, int np) {
  return (uint32_t)(bm + 2 * np) * WG_ROW;
}
// steps in the ring: four where they fit the 227 KB a block may have, else
// three
__host__ __device__ constexpr int k4f_stages(int bm, int np) {
  return 1024u + 4 * k4f_stage_bytes(bm, np) <= 232448 ? 4 : 3;
}
__host__ __device__ constexpr uint32_t k4f_smem_bytes(int bm, int np) {
  return 1024u + k4f_stages(bm, np) * k4f_stage_bytes(bm, np);
}

template <int BM, int N, int WN>
__global__ void __launch_bounds__(BM * 2 * WN, 1)
decode_fused_head_tf32x3_kernel(const float* __restrict__ x, long long sb,
                                long long sy, long long sx,
                                const float* __restrict__ w,
                                const float* __restrict__ w_lo,
                                const float* __restrict__ bias, int batch,
                                int gy, int gx, int cin, int n_anchors,
                                int n_classes, AnchorSet anchors,
                                float stride, float prob_thresh,
                                int head_offset, int n_total,
                                float* __restrict__ payload) {
  constexpr int NP = N * WN;            // columns of the tile: >= 5 + C
  constexpr int THREADS = BM * 2 * WN;  // (BM / 64) x WN warpgroups
  constexpr int G = THREADS / BM;
  constexpr int RPP = THREADS / 8;      // tile rows one pass of copies covers
  constexpr int A_IT = BM / RPP;        // copies per thread per step: A
  constexpr int B_IT = NP / RPP;        //                              B
  constexpr uint32_t A_BYTES = BM * WG_ROW;
  constexpr uint32_t STAGE_BYTES = k4f_stage_bytes(BM, NP);
  constexpr int STAGES = k4f_stages(BM, NP);
  static_assert(NP % RPP == 0 && BM % RPP == 0 && RPP % 8 == 0, "copies");
  static_assert(BM * (NP + G) * 4 <= STAGES * STAGE_BYTES,
                "the staged tile fits");

  extern __shared__ unsigned char k4f_smem[];
  const uint32_t raw = wg_smem_u32(k4f_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = k4f_smem + (ring - raw);

  const int tid = threadIdx.x;
  const int per = 5 + n_classes;
  const int cells = gy * gx;
  const int m_total = batch * cells;  // the C entry keeps it under 2^31
  const int a = blockIdx.x % n_anchors;
  const int m0 = (blockIdx.x / n_anchors) * BM;

  // this thread's copies: 16-byte chunk j (floats 4j .. 4j + 3) of rows
  // r0, r0 + RPP, ... of the A tile (cells) and of the B tile (the anchor's
  // weight rows); RPP % 8 == 0, so the swizzle term r & 7 is the same
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t row_off =
      (uint32_t)r0 * WG_ROW + (uint32_t)((j ^ (r0 & 7)) << 4);
  const float* a_src[A_IT];
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
      a_src[i] = x + pb * sb + py * sy + px * sx + j * 4;
      a_ok |= 1u << i;
    }
  }
  const int steps = cin / WG_F32;

  const int wgi = tid >> 7;         // warpgroup
  const int wm = wgi % (BM / 64);   // its rows: wm * 64 .. + 63
  const int wn = wgi / (BM / 64);   // its columns: wn * N .. + N - 1
  // the anchor's columns in pieces of NP, as in the bf16 kernel
  K4Cell cell;
  cell.best = -INFINITY;
  cell.best_i = n_classes;
  const int span = NP == K4_MAX_N ? per : 1;  // as in the bf16 kernel
  for (int c_base = 0; c_base < span; c_base += NP) {
    // the piece's weight rows: a * per + c_base .. + ncol - 1
    const long long b_src = ((long long)a * per + c_base + r0) * cin + j * 4;
    const int ncol = min(per - c_base, NP);
    int ld_step = 0;
    auto load_next = [&](int st) {
      if (ld_step < steps) {
        const uint32_t stage = ring + st * STAGE_BYTES;
        const int c0 = ld_step * WG_F32;
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
          const bool ok = (a_ok >> i) & 1u;
          wg_cp_async16(stage + row_off + i * RPP * WG_ROW,
                        ok ? a_src[i] + c0 : x, ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
          const bool ok = r0 + i * RPP < ncol;
          const long long off = ok ? b_src + (long long)i * RPP * cin + c0 : 0;
          const uint32_t dst = stage + A_BYTES + row_off + i * RPP * WG_ROW;
          wg_cp_async16(dst, w + off, ok ? 16 : 0);
          wg_cp_async16(dst + NP * WG_ROW, w_lo + off, ok ? 16 : 0);
        }
        ++ld_step;
      }
      wg_cp_async_commit();
    };

    float sum[N / 2];
    wg_gemm_tf32x3<BM, NP, N, STAGES>(sum, steps, ring, ring_ptr, wm, wn,
                                      load_next);
    k4_piece_epilogue<BM, N, WN>(sum, ring_ptr, wm, wn,
                                 bias + a * per + c_base, c_base, ncol, cell);
    // every lane has read the tile before the next piece fills the ring
    __syncthreads();
  }
  k4_store_record<BM, N, WN>(cell, ring_ptr, m0, a, m_total, gy, gx, anchors,
                             stride, prob_thresh, head_offset, n_total,
                             payload);
}

// ---------------------------------------------------------------- launch

// more than 48 KB of dynamic shared memory, and all of the 256 KB that
// shared memory may have
template <typename Kernel>
static cudaError_t k4_allow_smem(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// launches the kernel of x's type (T: bf16_bits or float) on one tile
// choice; MINB = 2 only at bf16; w_lo: the float32 kernel's lo weights
// (unread at bf16)
template <typename T, int BM, int N, int WN, int MINB>
static int launch_k4(const void* x, long long sb, long long sy, long long sx,
                     const void* w, const void* w_lo, const float* bias,
                     int batch, int gy, int gx, int cin, int n_anchors,
                     int n_classes, const AnchorSet& anchors, float stride,
                     float prob_thresh, int head_offset, int n_total,
                     float* payload, cudaStream_t s) {
  constexpr int NP = N * WN;
  const long long tiles = ((long long)batch * gy * gx + BM - 1) / BM;
  const unsigned blocks = (unsigned)(tiles * n_anchors);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    static_assert(MINB == 1, "the float32 kernel: one block a multiprocessor");
    auto kernel = decode_fused_head_tf32x3_kernel<BM, N, WN>;
    constexpr int SMEM = (int)k4f_smem_bytes(BM, NP);
    err = k4_allow_smem(kernel, SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, BM * 2 * WN, SMEM, s>>>(
        (const float*)x, sb, sy, sx, (const float*)w, (const float*)w_lo,
        bias, batch, gy, gx, cin, n_anchors, n_classes, anchors, stride,
        prob_thresh, head_offset, n_total, payload);
  } else {
    auto kernel = decode_fused_head_mma_kernel<BM, N, WN, MINB>;
    constexpr int SMEM = (int)k4t_smem_bytes(BM, NP, k4t_stages(BM, NP, MINB));
    err = k4_allow_smem(kernel, SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, BM * 2 * WN, SMEM, s>>>(
        (const bf16_bits*)x, sb, sy, sx, (const bf16_bits*)w, bias, batch, gy,
        gx, cin, n_anchors, n_classes, anchors, stride, prob_thresh,
        head_offset, n_total, payload);
  }
  return (int)cudaGetLastError();
}

// C entry (ctypes). x: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) pre-head
// activation addressed as x[b * sb + y * sy + xcol * sx + channel], channel
// stride 1, batch, row and pixel strides multiples of 16 bytes, x and w
// 16-byte aligned; w: the same type, (n_anchors * (5 + n_classes), cin)
// row-major, at float32 the weights' TF32 hi parts with w_lo, laid out as
// w, their TF32 lo parts (ops/tf32.py :: tf32_operands; not read at bf16);
// bias: float32 (n_anchors * (5 + n_classes)); anchors_wh: host
// array of 2 * n_anchors floats; payload: device float32 (batch, n_total,
// 8), contiguous, filled at [head_offset, head_offset + n_anchors * gy *
// gx). cin a multiple of 128; the tile (block_m, n_tile, resident) of
// ops/cuda_decode.py :: plan_fused_tiles: block_m 64 or 128, n_tile in {32,
// 64, 96, 128} (64 only above 128: 192, 256) and at least 5 + n_classes
// (256 above 256 columns: the pieces),
// resident 2 (blocks a multiprocessor) only at bf16, for cin <= 256 and
// block_m + n_tile <= 224, else 1. Launches on `stream`, allocates nothing,
// returns the CUDA error code (0 = success).
extern "C" int yolo_decode_packed_fused_head(
    const void* x, long long sb, long long sy, long long sx, int is_bf16,
    const void* w, const void* w_lo, const float* bias, int batch, int gy,
    int gx, int cin, int n_anchors, int n_classes, const float* anchors_wh,
    float stride, float prob_thresh, int head_offset, int n_total,
    int block_m, int n_tile, int resident, float* payload, void* stream) {
  const int per = 5 + n_classes;
  const int row = is_bf16 ? 8 : 4;  // elements of a 16-byte piece
  if (n_anchors < 1 || n_anchors > K1_MAX_ANCHORS || n_classes < 1 ||
      batch < 1 || gy < 1 || gx < 1 ||
      (long long)batch * gy * gx >= (1LL << 31) || cin < K4T_BK ||
      cin % K4T_BK != 0 || n_tile < (per < K4_MAX_N ? per : K4_MAX_N) ||
      sb % row || sy % row ||
      sx % row || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
      (!is_bf16 && (w_lo == nullptr || (uintptr_t)w_lo % 16)) ||
      (resident == 2 &&
       (!is_bf16 || cin > 2 * K4T_BK || block_m + n_tile > 224)))
    return (int)cudaErrorInvalidValue;
  AnchorSet anchors;
  for (int i = 0; i < 2 * n_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  cudaStream_t s = (cudaStream_t)stream;
#define K4_CASE(T, BM, NP, N, WN, MINB)                                     \
  if (block_m == BM && n_tile == NP && resident == MINB)                    \
    return launch_k4<T, BM, N, WN, MINB>(x, sb, sy, sx, w, w_lo, bias,      \
                                         batch, gy, gx, cin, n_anchors,     \
                                         n_classes, anchors, stride,        \
                                         prob_thresh, head_offset, n_total, \
                                         payload, s);
  if (!is_bf16) {
    K4_CASE(float, 64, 32, 32, 1, 1)
    K4_CASE(float, 64, 64, 64, 1, 1)
    K4_CASE(float, 64, 96, 96, 1, 1)
    K4_CASE(float, 64, 128, 128, 1, 1)
    K4_CASE(float, 128, 32, 32, 1, 1)
    K4_CASE(float, 128, 64, 64, 1, 1)
    K4_CASE(float, 128, 96, 96, 1, 1)
    K4_CASE(float, 128, 128, 128, 1, 1)
    K4_CASE(float, 64, 192, 96, 2, 1)
    K4_CASE(float, 64, 256, 128, 2, 1)
    return (int)cudaErrorInvalidValue;
  }
  K4_CASE(bf16_bits, 64, 32, 32, 1, 1)
  K4_CASE(bf16_bits, 64, 64, 64, 1, 1)
  K4_CASE(bf16_bits, 64, 96, 96, 1, 1)
  K4_CASE(bf16_bits, 64, 128, 128, 1, 1)
  K4_CASE(bf16_bits, 128, 32, 32, 1, 1)
  K4_CASE(bf16_bits, 128, 64, 64, 1, 1)
  K4_CASE(bf16_bits, 128, 96, 96, 1, 1)
  K4_CASE(bf16_bits, 128, 128, 128, 1, 1)
  K4_CASE(bf16_bits, 64, 192, 96, 2, 1)
  K4_CASE(bf16_bits, 64, 256, 128, 2, 1)
  K4_CASE(bf16_bits, 64, 32, 32, 1, 2)
  K4_CASE(bf16_bits, 64, 64, 64, 1, 2)
  K4_CASE(bf16_bits, 64, 96, 96, 1, 2)
  K4_CASE(bf16_bits, 64, 128, 128, 1, 2)
  K4_CASE(bf16_bits, 128, 32, 32, 1, 2)
  K4_CASE(bf16_bits, 128, 64, 64, 1, 2)
  K4_CASE(bf16_bits, 128, 96, 96, 1, 2)
#undef K4_CASE
  return (int)cudaErrorInvalidValue;
}
