// K1 (packed decode) and K1c (compact decode), CUDA C++ for sm_90a.
//
// Replace the TPU kernels yolov3_tpu/ops/pallas_decode.py ::
// decode_packed_head_pallas (K1) and decode_compact_head_pallas (K1c), both
// with the body _decode_compact_kernel + _decode_ft_records. Same records,
// no Pallas tiling carried over: for every (image, anchor, grid cell) the
// shared body (decode_common.cuh) decodes one candidate, at index
// n = head_offset + a * gy * gx + cell (anchor-major order). K1 writes the
// 8-float record
//
//   payload[b, n] = [x0, y0, x1, y1, score * [score >= prob_thresh],
//                    first-argmax class, cand = n, 0]
//
// and K1c splits the same record three ways, with no candidate lane:
// boxes[b, n] = [x0, y0, x1, y1], scores[b, n], classes[b, n] (int32).
//
// What bounds them on the H100: memory. They read the head map once (yolov3
// at 416, batch 8: about 29 MB over three heads at float32, half at bf16)
// and write the records once (about 2.7 MB); the arithmetic is a few exps
// per record. Design: one warp per (image, cell). The warp's lanes read the
// cell's channel row coalesced (class logits of one anchor are contiguous
// in the channels-last row), take the max / first argmax with a shuffle
// reduction, and lanes 0..7 store K1's record as one 32-byte store. The row
// is addressed by (batch, row, col) element strides passed in, so a
// channels-last view of a cuDNN output (or a channel-padded map) is read in
// place, with no copy. The map is float32 or bf16 (a template on the load
// type, widened exactly to float before any math). Anchors travel by value
// in the kernel's parameter block (up to K1_MAX_ANCHORS per head).

#include "decode_common.cuh"

#define K1_WARPS_PER_BLOCK 8

template <typename T>
struct GlobalRow {
  const T* row;
  __device__ __forceinline__ float operator()(int c) const {
    return k1_ldg(row + c);
  }
};

// PACKED: K1's 8-float records into `payload`; else K1c's three outputs.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(K1_WARPS_PER_BLOCK * 32)
decode_head_kernel(const T* __restrict__ feat, long long sb, long long sy,
                   long long sx, int batch, int gy, int gx, int n_anchors,
                   int n_classes, AnchorSet anchors, float stride,
                   float prob_thresh, int head_offset, int n_total,
                   float* __restrict__ payload, float* __restrict__ boxes,
                   float* __restrict__ scores, int* __restrict__ classes) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * K1_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int cells = gy * gx;
  if (item >= (long long)batch * cells) return;  // whole warp exits together
  const int b = (int)(item / cells);
  const int cell = (int)(item - (long long)b * cells);
  const int y = cell / gx;
  const int x = cell - y * gx;
  const GlobalRow<T> load{feat + b * sb + y * sy + x * sx};
  const int per = 5 + n_classes;

  for (int a = 0; a < n_anchors; ++a) {
    const K1Record r = k1_decode_anchor(load, a * per, n_classes, lane, x, y,
                                        stride, anchors.wh[2 * a],
                                        anchors.wh[2 * a + 1], prob_thresh);
    const int cand = head_offset + a * cells + cell;
    const long long slot = (long long)b * n_total + cand;
    if (PACKED) {
      k1_store_packed(r, lane, cand, payload + slot * 8);
    } else if (lane < 4) {
      boxes[slot * 4 + lane] =
          lane == 0 ? r.x0 : lane == 1 ? r.y0 : lane == 2 ? r.x1 : r.y1;
    } else if (lane == 4) {
      scores[slot] = r.score;
    } else if (lane == 5) {
      classes[slot] = r.cls;
    }
  }
}

template <bool PACKED>
static int launch_decode(const void* feat, long long sb, long long sy,
                         long long sx, int is_bf16, int batch, int gy, int gx,
                         int n_anchors, int n_classes, const float* anchors_wh,
                         float stride, float prob_thresh, int head_offset,
                         int n_total, float* payload, float* boxes,
                         float* scores, int* classes, void* stream) {
  if (n_anchors < 1 || n_anchors > K1_MAX_ANCHORS || n_classes < 1 ||
      batch < 1 || gy < 1 || gx < 1)
    return (int)cudaErrorInvalidValue;
  AnchorSet anchors;
  for (int i = 0; i < 2 * n_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  const long long items = (long long)batch * gy * gx;
  const unsigned blocks =
      (unsigned)((items + K1_WARPS_PER_BLOCK - 1) / K1_WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    decode_head_kernel<bf16_bits, PACKED><<<blocks, K1_WARPS_PER_BLOCK * 32,
                                            0, s>>>(
        (const bf16_bits*)feat, sb, sy, sx, batch, gy, gx, n_anchors,
        n_classes, anchors, stride, prob_thresh, head_offset, n_total,
        payload, boxes, scores, classes);
  } else {
    decode_head_kernel<float, PACKED><<<blocks, K1_WARPS_PER_BLOCK * 32, 0,
                                        s>>>(
        (const float*)feat, sb, sy, sx, batch, gy, gx, n_anchors, n_classes,
        anchors, stride, prob_thresh, head_offset, n_total, payload, boxes,
        scores, classes);
  }
  return (int)cudaGetLastError();
}

// C entries (ctypes). feat: a float32 (is_bf16 = 0) or bf16 (is_bf16 = 1)
// head map addressed as feat[b * sb + y * sy + x * sx + channel], channel
// stride 1. anchors_wh: a host array of 2 * n_anchors floats (w0, h0, w1,
// h1, ...). Outputs are device arrays over n_total candidates per image,
// contiguous; this head fills [head_offset, head_offset + n_anchors*gy*gx).
// Launch on `stream`, allocate nothing, return cudaGetLastError().

// K1: payload float32 (batch, n_total, 8)
extern "C" int yolo_decode_packed_head(const void* feat, long long sb,
                                       long long sy, long long sx,
                                       int is_bf16, int batch, int gy, int gx,
                                       int n_anchors, int n_classes,
                                       const float* anchors_wh, float stride,
                                       float prob_thresh, int head_offset,
                                       int n_total, float* payload,
                                       void* stream) {
  return launch_decode<true>(feat, sb, sy, sx, is_bf16, batch, gy, gx,
                             n_anchors, n_classes, anchors_wh, stride,
                             prob_thresh, head_offset, n_total, payload,
                             nullptr, nullptr, nullptr, stream);
}

// K1c: boxes float32 (batch, n_total, 4), scores float32 (batch, n_total),
// classes int32 (batch, n_total)
extern "C" int yolo_decode_compact_head(const void* feat, long long sb,
                                        long long sy, long long sx,
                                        int is_bf16, int batch, int gy, int gx,
                                        int n_anchors, int n_classes,
                                        const float* anchors_wh, float stride,
                                        float prob_thresh, int head_offset,
                                        int n_total, float* boxes,
                                        float* scores, int* classes,
                                        void* stream) {
  return launch_decode<false>(feat, sb, sy, sx, is_bf16, batch, gy, gx,
                              n_anchors, n_classes, anchors_wh, stride,
                              prob_thresh, head_offset, n_total, nullptr,
                              boxes, scores, classes, stream);
}
