// K3 (full decode), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_decode.py ::
// decode_head_pallas (body _decode_kernel): one head map
// (B, gy, gx, A * (5 + C)) becomes the reference Darknet.forward tensor
// (B, gy * gx * A, 5 + C), cell-major:
//
//   x, y : (sig(t) + cell column / row) * stride
//   w, h : exp(min(t, 60)) * anchor width / height
//   objectness and classes : sig(t)
//
// The TPU kernel selected among three full-tile results with per-channel
// mask vectors on 128-lane padded rows; here one thread computes one output
// element and takes the one branch its channel needs. The sigmoid, the
// clamp and expf are decode_common.cuh's, the functions K1 / K1c / K4 use,
// so the full decode cannot drift from the packed one, and with -fmad=false
// it equals its plain version (ops/decode.py :: decode_head) bit for bit.
//
// What bounds it: memory. Every map element is read once and written once
// (yolov3 at 416, batch 8, three heads: 29 MB in, 29 MB out at float32);
// consecutive threads read and write consecutive addresses. The map is
// addressed by (batch, row, col) element strides, so a channels-last view
// of a conv output is read in place; it is float32 or bf16 (widened
// exactly).

#include "decode_common.cuh"

#define K3_THREADS 256

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
decode_full_kernel(const T* __restrict__ feat, long long sb, long long sy,
                   long long sx, long long total, int gy, int gx, int per,
                   int row_len, AnchorSet anchors, float stride,
                   float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * K3_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % row_len);
  const long long cell_g = idx / row_len;
  const int cells = gy * gx;
  const int b = (int)(cell_g / cells);
  const int cell = (int)(cell_g - (long long)b * cells);
  const int y = cell / gx;
  const int x = cell - y * gx;
  const int a = ch / per;
  const int k = ch - a * per;
  const float t = k1_ldg(feat + b * sb + y * sy + x * sx + ch);
  float v;
  if (k == 0) {
    v = (k1_sigmoid(t) + (float)x) * stride;
  } else if (k == 1) {
    v = (k1_sigmoid(t) + (float)y) * stride;
  } else if (k == 2) {
    v = expf(k1_clamp60(t)) * anchors.wh[2 * a];
  } else if (k == 3) {
    v = expf(k1_clamp60(t)) * anchors.wh[2 * a + 1];
  } else {
    v = k1_sigmoid(t);
  }
  out[idx] = v;
}

// C entry (ctypes). feat: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) head
// map addressed as feat[b * sb + y * sy + x * sx + channel], channel stride
// 1, at least n_anchors * (5 + n_classes) channels. anchors_wh: host array
// of 2 * n_anchors floats. out: float32 (batch, gy * gx * n_anchors,
// 5 + n_classes) contiguous. Launch on `stream`, allocate nothing, return
// cudaGetLastError().
extern "C" int yolo_decode_full_head(const void* feat, long long sb,
                                     long long sy, long long sx, int is_bf16,
                                     int batch, int gy, int gx, int n_anchors,
                                     int n_classes, const float* anchors_wh,
                                     float stride, float* out, void* stream) {
  if (n_anchors < 1 || n_anchors > K1_MAX_ANCHORS || n_classes < 1 ||
      batch < 1 || gy < 1 || gx < 1)
    return (int)cudaErrorInvalidValue;
  AnchorSet anchors;
  for (int i = 0; i < 2 * n_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  const int per = 5 + n_classes;
  const int row_len = n_anchors * per;
  const long long total = (long long)batch * gy * gx * row_len;
  const long long blocks = (total + K3_THREADS - 1) / K3_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    decode_full_kernel<bf16_bits><<<(unsigned)blocks, K3_THREADS, 0, s>>>(
        (const bf16_bits*)feat, sb, sy, sx, total, gy, gx, per, row_len,
        anchors, stride, out);
  } else {
    decode_full_kernel<float><<<(unsigned)blocks, K3_THREADS, 0, s>>>(
        (const float*)feat, sb, sy, sx, total, gy, gx, per, row_len, anchors,
        stride, out);
  }
  return (int)cudaGetLastError();
}
