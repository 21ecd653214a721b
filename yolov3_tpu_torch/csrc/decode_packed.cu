// K1 (packed decode) and K1c (compact decode), CUDA C++ for sm_90a.
//
// Replace the TPU kernels yolov3_tpu/ops/pallas_decode.py ::
// decode_packed_head_pallas (K1) and decode_compact_head_pallas (K1c), both
// with the body _decode_compact_kernel + _decode_ft_records. One kernel with
// two stores: for every (image, anchor, grid cell) of every head the shared
// body (decode_common.cuh) decodes one candidate, at index
// n = head_offset + a * gy * gx + cell (anchor-major order). K1 writes the
// 8-float record
//
//   payload[b, n] = [x0, y0, x1, y1, score * [score >= prob_thresh],
//                    first-argmax class, cand = n, 0]
//
// and K1c splits the same record three ways, with no candidate lane:
// boxes[b, n] = [x0, y0, x1, y1], scores[b, n], classes[b, n] (int32).
//
// What bounds them on the H100: memory, by the bytes. They read the head
// maps once (yolov3 at 416, batch 8: 28.96 MB over three heads at float32,
// 14.48 MB at bf16) and write the records once (2.73 MB for K1): 5.1 us at
// bf16. The design before this one (a warp per cell, every lane computing
// the same record, a launch per head) was bound by issue instead: about
// 300 warp instructions a record. This one:
//
// * One launch for all the heads of a call. A head table travels by value
//   in the parameter block (K1Table: per head the map pointer, its element
//   strides, gy, gx, its anchors in the table's AnchorSet, stride, head
//   offset and first block); the per-head entry points pass a one-row
//   table. The wrapper's planner (ops/cuda_decode.py :: plan_decode) lays
//   the blocks out: block t of a head takes cells [t * TC, (t + 1) * TC) of
//   the head's flattened (image * gy * gx + cell) index, TC = 32 (16 where
//   32 rows would not fit shared memory).
// * Stage the cells in shared memory, then decode. Each warp stages the
//   32 / G cells it decodes and waits for those alone (cp.async wait and
//   __syncwarp, no block barrier), so a warp's decode overlaps the copies
//   still in flight for others. A dense channels-last map (cell stride = the
//   A * (5 + C) channels decoded, rows and images packed, base 16-byte
//   aligned) makes a warp's cells ONE contiguous range on a 16-byte boundary
//   (8 cells of bf16 are 16 * (A * (5 + C)) bytes): 16-byte cp.async
//   pieces, the tail piece cut by its source size. Any other map
//   (channel-padded, sliced) takes a strided element path in the same
//   kernel, a warp's lanes across a cell's channels. The planner decides
//   per head.
// * G = 2 or 4 adjacent lanes decode one (cell, anchor) with
//   k1_decode_anchor_group<G> reading the staged row (SharedMapRow), the
//   body K4's bf16 kernel runs: K1's float order to the bit, 8 to 16 times
//   fewer issue slots a record than a warp per cell. G is the planner's,
//   by map type: measured on the card (PERF.md; 8 lanes lost at both
//   types). G lanes of a record store its 32 bytes in 32 / G byte pieces,
//   so a warp writes whole runs of consecutive records; K1c's group stores
//   the box as one 16-byte piece, the score and the class.
//
// The map is float32 or bf16 (a template on the load type, widened exactly
// to float before any math).
//
// Ablation macros (yolov3_tpu_torch/tools/ablate_phases.py): -DK1_SKIP_COPY
// decodes whatever shared memory holds (no staging), -DK1_SKIP_DECODE stages
// and stores nothing.

#include "decode_common.cuh"
#include "wgmma_common.cuh"

#define K1_MAX_HEADS 8
#define K1_MAX_THREADS 128       // 32 cells x 4 lanes
#define K1_SMEM_LIMIT 232448     // 227 KB, a block's most on the H100
#define K1_HEAD_ARGS 11          // long longs a head in the C entry

struct K1Head {
  const void* feat;
  long long sb, sy, sx;  // element strides of image, row and column
  int gy, gx;
  int n_anchors, anchor0;  // anchors [anchor0, anchor0 + n_anchors) of the table
  int head_offset, first_block, dense;
  float stride;
};

struct K1Table {
  K1Head head[K1_MAX_HEADS];
  AnchorSet anchors;
  int n_heads;
};

template <typename T>
struct SharedMapRow {
  const T* row;
  __device__ __forceinline__ float operator()(int c) const {
    return k1_widen(row[c]);
  }
};

// PACKED: K1's 8-float records into `payload`; else K1c's three outputs.
// Block: tile_cells * G threads, G lanes a cell.
template <typename T, bool PACKED, int G>
__global__ void __launch_bounds__(K1_MAX_THREADS)
decode_heads_kernel(const K1Table tab, int batch, int n_classes,
                    int tile_cells, float prob_thresh, int n_total,
                    float* __restrict__ payload, float* __restrict__ boxes,
                    float* __restrict__ scores, int* __restrict__ classes) {
  static_assert(G == 2 || G == 4, "G: 2 or 4 lanes a record");
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* tile = reinterpret_cast<T*>(k1_smem);
  // this block's head: the last whose first block is at or before it
  // (static indices only, so the table stays in the parameter block)
  K1Head hd = tab.head[0];
#pragma unroll
  for (int i = 1; i < K1_MAX_HEADS; ++i)
    if (i < tab.n_heads && (int)blockIdx.x >= tab.head[i].first_block)
      hd = tab.head[i];
  const int per = 5 + n_classes;
  const int need = hd.n_anchors * per;  // channels a cell decodes
  const int cells = hd.gy * hd.gx;
  const long long m = (long long)batch * cells;
  const long long g0 = (long long)(blockIdx.x - hd.first_block) * tile_cells;
  const int n_rows = (int)min((long long)tile_cells, m - g0);
  const T* feat = static_cast<const T*>(hd.feat);

  // each warp stages the rows it decodes, and waits for those alone: the
  // warps of every block issue their copies at once, and each starts its
  // decode when its own rows have landed
  constexpr int CPW = 32 / G;  // cells a warp decodes
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * CPW;
  const int n_mine = max(0, min(CPW, n_rows - r0));
#ifndef K1_SKIP_COPY
  if (hd.dense) {
    // the warp's rows: one range of n_mine * need elements, on a 16-byte
    // boundary (CPW * need * sizeof(T) is a multiple of 16 for G <= 4)
    const char* src = reinterpret_cast<const char*>(feat + (g0 + r0) * need);
    const int bytes = n_mine * need * (int)sizeof(T);
    const uint32_t dst = wg_smem_u32(tile + r0 * need);
    for (int q = lane; q * 16 < bytes; q += 32)
      wg_cp_async16(dst + 16 * q, src + 16 * q, min(16, bytes - 16 * q));
    wg_cp_async_commit();
    wg_cp_async_wait<0>();
  } else {
    for (int rr = r0; rr < r0 + n_mine; ++rr) {
      const long long g = g0 + rr;
      const int b = (int)(g / cells);
      const int cell = (int)(g - (long long)b * cells);
      const int y = cell / hd.gx;
      const T* row = feat + b * hd.sb + y * hd.sy + (cell - y * hd.gx) * hd.sx;
      for (int c = lane; c < need; c += 32) tile[rr * need + c] = __ldg(row + c);
    }
  }
#endif
  __syncwarp();
#ifdef K1_SKIP_DECODE
  return;
#endif

  // G lanes a cell; rows past the head decode what shared memory holds
  // (every lane takes part in the shuffles) and store nothing
  const int r = threadIdx.x / G, jg = threadIdx.x % G;
  const bool live = r < n_rows;
  int b = 0, cell = 0;
  if (live) {
    b = (int)((g0 + r) / cells);
    cell = (int)(g0 + r - (long long)b * cells);
  }
  const int y = cell / hd.gx, x = cell - (cell / hd.gx) * hd.gx;
  const SharedMapRow<T> load{tile + r * need};
  for (int a = 0; a < hd.n_anchors; ++a) {
    const int an = hd.anchor0 + a;
    const K1Record rec = k1_decode_anchor_group<G>(
        load, a * per, n_classes, jg, x, y, hd.stride, tab.anchors.wh[2 * an],
        tab.anchors.wh[2 * an + 1], prob_thresh);
    if (!live) continue;
    const int cand = hd.head_offset + a * cells + cell;
    const long long slot = (long long)b * n_total + cand;
    if constexpr (PACKED) {
      constexpr int P = 8 / G;  // floats of the record this lane stores
      float v[P];
#pragma unroll
      for (int q = 0; q < P; ++q) v[q] = k1_record_lane(rec, jg * P + q, cand);
      float* out = payload + slot * 8 + jg * P;
      if constexpr (P == 4)
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      else if constexpr (P == 2)
        *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
      else
        *out = v[0];
    } else {
      if (jg == 0)
        *reinterpret_cast<float4*>(boxes + slot * 4) =
            make_float4(rec.x0, rec.y0, rec.x1, rec.y1);
      if (jg == 1) scores[slot] = rec.score;
      if (jg == G - 1) classes[slot] = rec.cls;
    }
  }
}

template <typename T, bool PACKED, int G>
static int launch_heads(const K1Table& tab, int blocks, int tile_cells,
                        int smem, int batch, int n_classes, float prob_thresh,
                        int n_total, float* payload, float* boxes,
                        float* scores, int* classes, cudaStream_t s) {
  static bool allowed[WG_MAX_DEVICES];
  const cudaError_t e = wg_allow_smem(decode_heads_kernel<T, PACKED, G>,
                                      K1_SMEM_LIMIT, allowed);
  if (e != cudaSuccess) return (int)e;
  decode_heads_kernel<T, PACKED, G><<<blocks, tile_cells * G, smem, s>>>(
      tab, batch, n_classes, tile_cells, prob_thresh, n_total, payload, boxes,
      scores, classes);
  return (int)cudaGetLastError();
}

template <typename T, bool PACKED>
static int launch_group(int group, const K1Table& tab, int blocks,
                        int tile_cells, int smem, int batch, int n_classes,
                        float prob_thresh, int n_total, float* payload,
                        float* boxes, float* scores, int* classes,
                        cudaStream_t s) {
  switch (group) {
    case 2:
      return launch_heads<T, PACKED, 2>(tab, blocks, tile_cells, smem, batch,
                                        n_classes, prob_thresh, n_total,
                                        payload, boxes, scores, classes, s);
    case 4:
      return launch_heads<T, PACKED, 4>(tab, blocks, tile_cells, smem, batch,
                                        n_classes, prob_thresh, n_total,
                                        payload, boxes, scores, classes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C entry (ctypes). head_args: per head K1_HEAD_ARGS long longs
//   [map pointer, sb, sy, sx, gy, gx, n_anchors, anchor0, head_offset,
//    first_block, dense]
// with the map a float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) channels-last
// array addressed as feat[b * sb + y * sy + x * sx + channel]; head_strides:
// per head its stride in pixels; anchors_wh: 2 * n_anchors_total floats (w0,
// h0, w1, h1, ...) of all heads in order. Outputs are device arrays over
// n_total candidates per image, contiguous; packed = 1: payload float32
// (batch, n_total, 8); packed = 0: boxes float32 (batch, n_total, 4), scores
// float32 (batch, n_total), classes int32 (batch, n_total). group: lanes a
// cell (2 or 4); tile_cells: 16 or 32; blocks: the table's total. Launch
// on `stream`, allocate nothing, return the CUDA error code (0 on success).
extern "C" int yolo_decode_heads(const long long* head_args,
                                 const float* head_strides, int n_heads,
                                 const float* anchors_wh, int n_anchors_total,
                                 int is_bf16, int packed, int group,
                                 int tile_cells, int blocks, int batch,
                                 int n_classes, float prob_thresh, int n_total,
                                 float* payload, float* boxes, float* scores,
                                 int* classes, void* stream) {
  if (n_heads < 1 || n_heads > K1_MAX_HEADS || n_anchors_total < 1 ||
      n_anchors_total > K1_MAX_ANCHORS || n_classes < 1 || batch < 1 ||
      blocks < 1 || (tile_cells != 16 && tile_cells != 32))
    return (int)cudaErrorInvalidValue;
  K1Table tab;
  tab.n_heads = n_heads;
  int max_need = 0;
  for (int h = 0; h < n_heads; ++h) {
    const long long* a = head_args + (long long)h * K1_HEAD_ARGS;
    K1Head& hd = tab.head[h];
    hd.feat = reinterpret_cast<const void*>(a[0]);
    hd.sb = a[1];
    hd.sy = a[2];
    hd.sx = a[3];
    hd.gy = (int)a[4];
    hd.gx = (int)a[5];
    hd.n_anchors = (int)a[6];
    hd.anchor0 = (int)a[7];
    hd.head_offset = (int)a[8];
    hd.first_block = (int)a[9];
    hd.dense = (int)a[10];
    hd.stride = head_strides[h];
    if (hd.gy < 1 || hd.gx < 1 || hd.n_anchors < 1 ||
        hd.anchor0 + hd.n_anchors > n_anchors_total)
      return (int)cudaErrorInvalidValue;
    const int need = hd.n_anchors * (5 + n_classes);
    if (need > max_need) max_need = need;
  }
  for (int h = n_heads; h < K1_MAX_HEADS; ++h) tab.head[h] = tab.head[0];
  for (int i = 0; i < 2 * n_anchors_total; ++i)
    tab.anchors.wh[i] = anchors_wh[i];
  const long long smem =
      (long long)tile_cells * max_need * (is_bf16 ? 2 : 4);
  if (smem > K1_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return packed ? launch_group<bf16_bits, true>(
                        group, tab, blocks, tile_cells, (int)smem, batch,
                        n_classes, prob_thresh, n_total, payload, boxes, scores,
                        classes, s)
                  : launch_group<bf16_bits, false>(
                        group, tab, blocks, tile_cells, (int)smem, batch,
                        n_classes, prob_thresh, n_total, payload, boxes, scores,
                        classes, s);
  }
  return packed ? launch_group<float, true>(group, tab, blocks, tile_cells,
                                            (int)smem, batch, n_classes,
                                            prob_thresh, n_total, payload,
                                            boxes, scores, classes, s)
                : launch_group<float, false>(group, tab, blocks, tile_cells,
                                             (int)smem, batch, n_classes,
                                             prob_thresh, n_total, payload,
                                             boxes, scores, classes, s);
}
