// K2: greedy class-aware suppression, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_nms.py :: pallas_suppress
// (body _nms_kernel), which is bit-identical to the XLA blocked loop
// yolov3_tpu/ops/nms.py :: _greedy_suppress_blocked_fused. Input: per image,
// K score-sorted tlbr boxes, their classes and a valid mask. Output: the
// keep mask of exact greedy NMS in score order,
//
//   keep[i] = valid[i] and no j < i with keep[j] and conflict(j, i),
//   conflict(i, j) = IoU(i, j) > iou_thresh and class[i] == class[j],
//   IoU = inter / max(union, 1e-9),  union = (area_i + area_j) - inter.
//
// What bounds it on the H100: the K sequential greedy steps, not bytes (the
// inputs are K * 24 bytes per image) and not the K^2 IoUs. Design: one block
// per image.
//   Phase 1: all 1024 threads build the K x K conflict matrix as a bitmask
//   in shared memory (32 bits per word, rows padded to an odd word count so
//   the column-major fill does not bank-conflict): K = 512 takes 34 KB,
//   K = 1024 takes 132 KB, which needs dynamic shared memory above 48 KB.
//   Phase 2: one warp walks the candidates in order. Lane l holds word l of
//   a K-bit "removed" mask in a register (K <= 1024 means at most 32 words).
//   Step i reads bit i with one shuffle; if i is kept, every lane ORs word l
//   of row i into its word. Each step is a shuffle and one shared-memory
//   load, so the K steps cost cycles, not launches or host round trips.
// The conflict test is symmetric bit for bit (fmaxf/fminf and the area sum
// commute), so ORing row i equals reading column i as the references do.
//
// Float contract: built with -fmad=false and without fast math: the union
// (area_i + area_j) - inter must not contract into an FMA, or keep masks
// stop matching the plain PyTorch version
// (yolov3_tpu_torch/ops/cuda_nms.py :: suppress_reference) bit for bit.

#include <cuda_runtime.h>

#define K2_THREADS 1024
#define K2_MAX_K 1024

__host__ __device__ inline size_t k2_smem_bytes(int k) {
  const int words = (k + 31) >> 5;
  // float4 boxes | float area | int class | uchar valid (padded to 4) | bits
  return (size_t)k * 16 + (size_t)k * 4 + (size_t)k * 4 +
         (size_t)((k + 3) & ~3) + (size_t)k * (words + 1) * 4;
}

__global__ void __launch_bounds__(K2_THREADS)
nms_suppress_kernel(const float4* __restrict__ boxes,
                    const int* __restrict__ classes,
                    const unsigned char* __restrict__ valid, int k,
                    float iou_thresh, unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5;
  const int row_stride = words + 1;  // odd: conflict-free column fill
  float4* bx = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(bx + k);
  int* cls = reinterpret_cast<int*>(area + k);
  unsigned char* vld = reinterpret_cast<unsigned char*>(cls + k);
  unsigned* conflict = reinterpret_cast<unsigned*>(vld + ((k + 3) & ~3));

  const long long base = (long long)blockIdx.x * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 b = boxes[base + i];
    bx[i] = b;
    area[i] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    cls[i] = classes[base + i];
    vld[i] = valid[base + i];
  }
  __syncthreads();

  // Phase 1: word (i, jw) holds conflict(i, 32 * jw + t) in bit t. i varies
  // fastest across threads, so box j is a broadcast read.
  for (int w = threadIdx.x; w < k * words; w += blockDim.x) {
    const int jw = w / k;
    const int i = w - jw * k;
    const float4 bi = bx[i];
    const float ai = area[i];
    const int ci = cls[i];
    const int j0 = jw * 32;
    const int jn = min(32, k - j0);
    unsigned bits = 0u;
    for (int t = 0; t < jn; ++t) {
      const int j = j0 + t;
      const float4 bj = bx[j];
      const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
      const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
      const float inter = iw * ih;
      const float uni = ai + area[j] - inter;
      // max(union, 1e-9) that keeps a NaN (inf - inf on exp-clamped boxes),
      // like torch.clamp_min / jnp.maximum
      const float den = uni != uni ? uni : fmaxf(uni, 1e-9f);
      if (inter / den > iou_thresh && ci == cls[j]) bits |= 1u << t;
    }
    conflict[i * row_stride + jw] = bits;
  }
  __syncthreads();

  // Phase 2: one warp, exact greedy in score order.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned removed = 0u;
    for (int i = 0; i < k; ++i) {
      const unsigned word = __shfl_sync(0xffffffffu, removed, i >> 5);
      const bool kept = vld[i] && !((word >> (i & 31)) & 1u);
      if (kept && lane < words) removed |= conflict[i * row_stride + lane];
      if (lane == 0) keep[base + i] = kept ? 1 : 0;
    }
  }
}

// C entry (ctypes). boxes: device float32 (batch, k, 4) contiguous; classes:
// int32 (batch, k); valid and keep: bool / uint8 (batch, k). Launches on
// `stream`, allocates nothing, returns the CUDA error code (0 on success).
extern "C" int yolo_nms_suppress(const float* boxes, const int* classes,
                                 const unsigned char* valid, int batch, int k,
                                 float iou_thresh, unsigned char* keep,
                                 void* stream) {
  if (batch < 1 || k < 1 || k > K2_MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = k2_smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_suppress_kernel<<<batch, K2_THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), classes, valid, k, iou_thresh,
      keep);
  return (int)cudaGetLastError();
}
