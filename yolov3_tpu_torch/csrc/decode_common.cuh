// Shared YOLO head decode body of K1, K1c and K4 (CUDA C++, sm_90a).
//
// The TPU kernels share one body too (yolov3_tpu/ops/pallas_decode.py ::
// _decode_ft_records); here it is k1_decode_anchor_group, a device function
// that a group of lanes runs for one (cell, anchor) with the kernel's own
// row loader: the whole warp in K1, K1c and K4's float32 kernel
// (k1_decode_anchor), two or four lanes in K4's bf16 kernel, so their record
// math cannot drift apart. For one (cell, anchor) it computes
//
//   cx = (sig(tx) + col) * stride,   w = exp(min(tw, 60)) * anchor_w,
//   x0 = cx - w * 0.5,  x1 = cx + w * 0.5,  (same for y)
//   score = sig(obj) * sig(max class logit), zeroed below prob_thresh,
//   class = first argmax of the class logits.
//
// Sigmoid is monotone, so the class max and its first argmax are taken on
// the logits and only the max goes through the sigmoid.
//
// Float contract: the library builds with -fmad=false and without fast
// math, so every product and sum here rounds separately, in the order of
// the plain PyTorch version (yolov3_tpu_torch/ops/cuda_decode.py ::
// decode_packed_head_reference); expf is the full-precision exp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define K1_MAX_ANCHORS 64

struct AnchorSet {
  float wh[2 * K1_MAX_ANCHORS];
};

// bf16 head maps travel as their raw 16-bit patterns; widening to float is
// a shift, and exact.
typedef unsigned short bf16_bits;

__device__ __forceinline__ float k1_widen(float v) { return v; }
__device__ __forceinline__ float k1_widen(bf16_bits v) {
  return __uint_as_float(((unsigned)v) << 16);
}

// read-only global load of one map element, widened to float
template <typename T>
__device__ __forceinline__ float k1_ldg(const T* p) {
  return k1_widen(__ldg(p));
}

__device__ __forceinline__ float k1_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// min(t, 60) that keeps a NaN, like torch.clamp / jnp.minimum
__device__ __forceinline__ float k1_clamp60(float t) {
  return t != t ? t : fminf(t, 60.0f);
}

struct K1Record {
  float x0, y0, x1, y1, score;
  int cls;
};

// Decode anchor channels [base, base + 5 + n_classes) of one cell with a
// group of G adjacent lanes (G a power of two, at most 32): lane j of the
// group takes class logits j, j + G, ...; every lane of the WARP calls it
// together (the class reduction shuffles) and every lane of the group gets
// the record. `load(c)` returns channel c of the cell's row as float. The
// max and its first argmax do not depend on the order of the reduction:
// equal values keep the lower index, and a NaN never wins.
template <int G, class Load>
__device__ __forceinline__ K1Record k1_decode_anchor_group(
    const Load& load, int base, int n_classes, int j, int col, int row,
    float stride, float anchor_w, float anchor_h, float prob_thresh) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two");
  // lane-local max and first argmax over this lane's class logits
  float best = -INFINITY;
  int best_i = n_classes;
  for (int k = j; k < n_classes; k += G) {
    const float v = load(base + 5 + k);
    if (v > best || (v == best && k < best_i)) {
      best = v;
      best_i = k;
    }
  }
  // group reduction: larger value wins, equal values keep the lower index
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  const float tx = load(base + 0), ty = load(base + 1);
  const float tw = load(base + 2), th = load(base + 3);
  const float obj = load(base + 4);
  const float cx = (k1_sigmoid(tx) + (float)col) * stride;
  const float cy = (k1_sigmoid(ty) + (float)row) * stride;
  const float w = expf(k1_clamp60(tw)) * anchor_w;
  const float h = expf(k1_clamp60(th)) * anchor_h;
  float score = k1_sigmoid(obj) * k1_sigmoid(best);
  score = score >= prob_thresh ? score : 0.0f;
  K1Record r;
  r.x0 = cx - w * 0.5f;
  r.y0 = cy - h * 0.5f;
  r.x1 = cx + w * 0.5f;
  r.y1 = cy + h * 0.5f;
  r.score = score;
  r.cls = best_i;
  return r;
}

// The warp-wide decode of K1, K1c and K4's float32 kernel: all 32 lanes
// decode one cell's anchor together.
template <class Load>
__device__ __forceinline__ K1Record k1_decode_anchor(
    const Load& load, int base, int n_classes, int lane, int col, int row,
    float stride, float anchor_w, float anchor_h, float prob_thresh) {
  return k1_decode_anchor_group<32>(load, base, n_classes, lane, col, row,
                                    stride, anchor_w, anchor_h, prob_thresh);
}

// lane `lane` of the 8-float record [x0, y0, x1, y1, score, class, cand, 0]
__device__ __forceinline__ float k1_record_lane(const K1Record& r, int lane,
                                                int cand) {
  switch (lane) {
    case 0: return r.x0;
    case 1: return r.y0;
    case 2: return r.x1;
    case 3: return r.y1;
    case 4: return r.score;
    case 5: return (float)r.cls;
    case 6: return (float)cand;
    default: return 0.0f;
  }
}

// K1's epilogue: lanes 0..7 store the 8-float record
// [x0, y0, x1, y1, score, class, cand, 0] as one 32-byte coalesced store.
__device__ __forceinline__ void k1_store_packed(const K1Record& r, int lane,
                                                int cand, float* rec8) {
  if (lane < 8) rec8[lane] = k1_record_lane(r, lane, cand);
}
