// Shared YOLO head decode body of K1, K1c and K4 (CUDA C++, sm_90a).
//
// The TPU kernels share one body too (yolov3_tpu/ops/pallas_decode.py ::
// _decode_ft_records); here it is k1_decode_anchor_group, a device function
// that a group of lanes runs for one (cell, anchor) with the kernel's own
// row loader: G lanes in K1 and K1c (decode_packed.cu) and in both of K4's
// kernels (decode_fused.cu), so their record math cannot drift apart. For
// one (cell, anchor) it computes
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

// Lane j of a group of G scans class logits k = k_begin + j, + G, ...
// below k_end, read as channel col0 + k of the row, into its running max
// `best` and first argmax `best_i`: a larger value wins, an equal one keeps
// the lower index, and a NaN never wins. A caller that holds a row in
// pieces calls it once a piece, with the same `best` and `best_i`.
template <int G, class Load>
__device__ __forceinline__ void k1_scan_classes(const Load& load, int col0,
                                                int k_begin, int k_end, int j,
                                                float& best, int& best_i) {
  for (int k = k_begin + j; k < k_end; k += G) {
    const float v = load(col0 + k);
    if (v > best || (v == best && k < best_i)) {
      best = v;
      best_i = k;
    }
  }
}

// the group's reduction of its lanes' (best, best_i): every lane of the
// group gets the max and its first argmax, whatever order the lanes'
// classes were scanned in. Every lane of the WARP calls it together.
template <int G>
__device__ __forceinline__ void k1_group_best(float& best, int& best_i) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
}

// The record of one (cell, anchor) from its box and objectness channels
// base .. base + 4 (`load(c)`) and the group's class max and first argmax
// (k1_group_best). Every lane of the WARP calls it together.
template <int G, class Load>
__device__ __forceinline__ K1Record k1_decode_finish(
    const Load& load, int base, float best, int best_i, int j, int col,
    int row, float stride, float anchor_w, float anchor_h,
    float prob_thresh) {
  // the record's six transcendental values, sigmoid of tx, ty, obj and
  // the best logit and exp of the clamped tw and th, spread over the
  // group: lane j computes sigmoid input j mod 4 (and j + 2 with two
  // lanes) and exp input j mod 2, then the group shares them by shuffles.
  // Every lane still gets every value, bit for bit the one it would
  // compute itself, at a half to a third of the lanes' work.
  const float tw = load(base + 2), th = load(base + 3);
  float sig[4], ex[2];
  if constexpr (G == 1) {
    sig[0] = k1_sigmoid(load(base + 0));
    sig[1] = k1_sigmoid(load(base + 1));
    sig[2] = k1_sigmoid(load(base + 4));
    sig[3] = k1_sigmoid(best);
    ex[0] = expf(k1_clamp60(tw));
    ex[1] = expf(k1_clamp60(th));
  } else {
    // sigmoid inputs 0..3: tx, ty, obj, the best logit
    auto sig_in = [&](int q) {
      return q == 3 ? best : load(base + (q == 2 ? 4 : q));
    };
    const float e = expf(k1_clamp60((j & 1) ? th : tw));
    const float s0 = k1_sigmoid(sig_in(j & 3));
    const float s1 = G == 2 ? k1_sigmoid(sig_in((j & 1) + 2)) : s0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sig[q] = __shfl_sync(0xffffffffu, G == 2 && q >= 2 ? s1 : s0, q % G, G);
    ex[0] = __shfl_sync(0xffffffffu, e, 0, G);
    ex[1] = __shfl_sync(0xffffffffu, e, 1, G);
  }
  const float cx = (sig[0] + (float)col) * stride;
  const float cy = (sig[1] + (float)row) * stride;
  const float w = ex[0] * anchor_w;
  const float h = ex[1] * anchor_h;
  float score = sig[2] * sig[3];
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

// Decode anchor channels [base, base + 5 + n_classes) of one cell with a
// group of G adjacent lanes (G a power of two, at most 32): lane j of the
// group takes class logits j, j + G, ... and a share of the sigmoids and
// exps; every lane of the WARP calls it together (the reductions shuffle)
// and every lane of the group gets the record. `load(c)` returns channel c
// of the cell's row as float. The max and its first argmax do not depend on
// the order of the reduction: equal values keep the lower index, and a NaN
// never wins.
template <int G, class Load>
__device__ __forceinline__ K1Record k1_decode_anchor_group(
    const Load& load, int base, int n_classes, int j, int col, int row,
    float stride, float anchor_w, float anchor_h, float prob_thresh) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two");
  float best = -INFINITY;
  int best_i = n_classes;
  k1_scan_classes<G>(load, base + 5, 0, n_classes, j, best, best_i);
  k1_group_best<G>(best, best_i);
  return k1_decode_finish<G>(load, base, best, best_i, j, col, row, stride,
                             anchor_w, anchor_h, prob_thresh);
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
