// Shared YOLO head decode body of K1, K1c and K4 (CUDA C++, sm_90a).
//
// The TPU kernels share one body too (yolov3_tpu/ops/pallas_decode.py ::
// _decode_ft_records); here it is k1_decode_anchor_group, a device function
// that a group of lanes runs for one (cell, anchor) with the kernel's own
// row loader: G lanes in K1 and K1c (decode_packed.cu) and in K4's bf16
// kernel, the whole warp in K4's float32 kernel (k1_decode_anchor), so
// their record math cannot drift apart. For one (cell, anchor) it computes
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

// The warp-wide decode of K4's float32 kernel: all 32 lanes decode one
// cell's anchor together.
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

// K4's float32 epilogue: lanes 0..7 store the 8-float record
// [x0, y0, x1, y1, score, class, cand, 0] as one 32-byte coalesced store.
__device__ __forceinline__ void k1_store_packed(const K1Record& r, int lane,
                                                int cand, float* rec8) {
  if (lane < 8) rec8[lane] = k1_record_lane(r, lane, cand);
}
