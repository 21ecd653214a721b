// K1: packed YOLO head decode, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_decode.py ::
// decode_packed_head_pallas (body _decode_compact_kernel + _decode_ft_records).
// Same records, no Pallas tiling carried over: for every (image, anchor, grid
// cell) it writes the 8-float candidate record
//
//   [x0, y0, x1, y1, score * [score >= prob_thresh], first-argmax class,
//    cand = head_offset + a * gy * gx + cell, 0]
//
// at payload[b, head_offset + a * gy * gx + cell] (anchor-major order), where
//   cx = (sig(tx) + col) * stride,  w = exp(min(tw, 60)) * anchor_w,
//   x0 = cx - w * 0.5,  x1 = cx + w * 0.5,  score = sig(obj) * sig(max logit).
// Sigmoid is monotone, so the class max and its first argmax are taken on
// the logits and only the max goes through the sigmoid.
//
// What bounds it on the H100: memory. It reads the head map once (yolov3 at
// 416, batch 8: about 29 MB over three heads) and writes the payload once
// (about 2.7 MB); the arithmetic is a few exps per record. Design: one warp
// per (image, cell). The warp's lanes read the cell's channel row coalesced
// (class logits of one anchor are contiguous in the channels-last row), take
// the max / first argmax with a shuffle reduction, and lanes 0..7 store the
// record's 8 floats as one 32-byte coalesced store. The row is addressed by
// (batch, row, col) element strides passed in, so a channels-last view of a
// cuDNN output (or a channel-padded map) is read in place, with no copy.
// Anchors travel by value in the kernel's parameter block (up to
// K1_MAX_ANCHORS per head).
//
// Float contract: built with -fmad=false and without fast math, so every
// product and sum rounds separately, as in the plain PyTorch version
// (yolov3_tpu_torch/ops/cuda_decode.py :: decode_packed_head_reference).
// expf is the full-precision libdevice exp (no __expf).

#include <cuda_runtime.h>
#include <math.h>

#define K1_MAX_ANCHORS 64
#define K1_WARPS_PER_BLOCK 8

struct AnchorSet {
  float wh[2 * K1_MAX_ANCHORS];
};

__device__ __forceinline__ float k1_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// min(t, 60) that keeps a NaN, like torch.clamp / jnp.minimum
__device__ __forceinline__ float k1_clamp60(float t) {
  return t != t ? t : fminf(t, 60.0f);
}

__global__ void __launch_bounds__(K1_WARPS_PER_BLOCK * 32)
decode_packed_head_kernel(const float* __restrict__ feat, long long sb,
                          long long sy, long long sx, int batch, int gy,
                          int gx, int n_anchors, int n_classes,
                          AnchorSet anchors, float stride, float prob_thresh,
                          int head_offset, int n_total,
                          float* __restrict__ payload) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * K1_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int cells = gy * gx;
  if (item >= (long long)batch * cells) return;  // whole warp exits together
  const int b = (int)(item / cells);
  const int cell = (int)(item - (long long)b * cells);
  const int y = cell / gx;
  const int x = cell - y * gx;
  const float* row = feat + b * sb + y * sy + x * sx;
  const int per = 5 + n_classes;

  for (int a = 0; a < n_anchors; ++a) {
    const float* r = row + a * per;
    // lane-local max and first argmax over this lane's class logits
    float best = -INFINITY;
    int best_i = n_classes;
    for (int k = lane; k < n_classes; k += 32) {
      const float v = __ldg(r + 5 + k);
      if (v > best || (v == best && k < best_i)) {
        best = v;
        best_i = k;
      }
    }
    // warp reduction: larger value wins, equal values keep the lower index
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane < 8) {
      const float tx = __ldg(r + 0), ty = __ldg(r + 1);
      const float tw = __ldg(r + 2), th = __ldg(r + 3);
      const float obj = __ldg(r + 4);
      const float cx = (k1_sigmoid(tx) + (float)x) * stride;
      const float cy = (k1_sigmoid(ty) + (float)y) * stride;
      const float w = expf(k1_clamp60(tw)) * anchors.wh[2 * a];
      const float h = expf(k1_clamp60(th)) * anchors.wh[2 * a + 1];
      float score = k1_sigmoid(obj) * k1_sigmoid(best);
      score = score >= prob_thresh ? score : 0.0f;
      const int cand = head_offset + a * cells + cell;
      float v;
      switch (lane) {
        case 0: v = cx - w * 0.5f; break;
        case 1: v = cy - h * 0.5f; break;
        case 2: v = cx + w * 0.5f; break;
        case 3: v = cy + h * 0.5f; break;
        case 4: v = score; break;
        case 5: v = (float)best_i; break;
        case 6: v = (float)cand; break;
        default: v = 0.0f; break;
      }
      payload[((long long)b * n_total + cand) * 8 + lane] = v;
    }
  }
}

// C entry (ctypes). feat: float32 head map addressed as
// feat[b * sb + y * sy + x * sx + channel], channel stride 1. anchors_wh: a
// host array of 2 * n_anchors floats (w0, h0, w1, h1, ...). payload: device
// float32 (batch, n_total, 8), contiguous. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (0 on success).
extern "C" int yolo_decode_packed_head(const float* feat, long long sb,
                                       long long sy, long long sx, int batch,
                                       int gy, int gx, int n_anchors,
                                       int n_classes, const float* anchors_wh,
                                       float stride, float prob_thresh,
                                       int head_offset, int n_total,
                                       float* payload, void* stream) {
  if (n_anchors < 1 || n_anchors > K1_MAX_ANCHORS || n_classes < 1 ||
      batch < 1 || gy < 1 || gx < 1)
    return (int)cudaErrorInvalidValue;
  AnchorSet anchors;
  for (int i = 0; i < 2 * n_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  const long long items = (long long)batch * gy * gx;
  const unsigned blocks =
      (unsigned)((items + K1_WARPS_PER_BLOCK - 1) / K1_WARPS_PER_BLOCK);
  decode_packed_head_kernel<<<blocks, K1_WARPS_PER_BLOCK * 32, 0,
                              (cudaStream_t)stream>>>(
      feat, sb, sy, sx, batch, gy, gx, n_anchors, n_classes, anchors, stride,
      prob_thresh, head_offset, n_total, payload);
  return (int)cudaGetLastError();
}
