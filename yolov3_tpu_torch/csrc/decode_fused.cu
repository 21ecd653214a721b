// K4: packed YOLO head decode fused with the 1x1 head conv, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_decode.py ::
// decode_packed_head_fused_pallas (body _decode_packed_fused_kernel). Input
// is the PRE-head activation x (B, gy, gx, Cin), channels-last with channel
// stride 1, and the head conv's weights w (Cout, Cin) row-major (the port's
// channels_last OIHW buffer of a 1x1 conv, viewed 2-D) with a float32 bias.
// For every cell it computes the head row h = x_row . w^T + bias (float32
// accumulation) and feeds h to the shared decode body (decode_common.cuh),
// writing K1's 8-float records at payload[b, head_offset + a*gy*gx + cell].
// The head map itself never reaches device memory.
//
// What bounds it on the H100: for yolov3 at 416, batch 8, it reads about
// 38.8 MB of pre-head activations at float32 (13^2 x 1024, 26^2 x 512 and
// 52^2 x 256 per image) and does 4.94 GFLOP; at 3.35 TB/s and the 67 TFLOP/s
// float32 CUDA-core rate both bounds are near 0.07-0.12 ms, so neither
// dominates, and the simple design below is bound by its shared-memory
// operand traffic instead. The head maps it skips are 29 MB of writes plus
// 29 MB of reads.
//
// Design (a simple kernel that is right; wgmma / TMA come later): one block
// of 256 threads takes K4_ROWS = 32 consecutive cells (rows of the
// flattened B*gy*gx x Cin map). Thread t owns output channels t, t+256, ...
// (K4_CPT of them) for all 32 cells, so it keeps 32*K4_CPT float32
// accumulators in registers. The reduction runs in Cin chunks of K4_KC =
// 32: the block stages the x chunk (32 cells x 32 channels, coalesced rows)
// and the w chunk, transposed to [k][cout] so each thread reads its own
// channel conflict-free, in shared memory; every thread then reads the x
// values as 16-byte broadcasts. Products accumulate with __fmaf_rn (one
// rounding per multiply-add; the -fmad=false build flag does not touch the
// intrinsic) in sequential Cin order. After the loop the accumulators plus
// bias go to a shared (32 x Cout) tile that aliases the staging buffers, and
// the block's 8 warps run the shared decode epilogue on it, one cell at a
// time, in K1's no-FMA float order.

#include "decode_common.cuh"

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

// C entry (ctypes). x: float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) pre-head
// activation addressed as x[b * sb + y * sy + xcol * sx + channel], channel
// stride 1; w: the same type, (n_anchors * (5 + n_classes), cin) row-major;
// bias: float32 (n_anchors * (5 + n_classes)); anchors_wh: host array of 2 *
// n_anchors floats; payload: device float32 (batch, n_total, 8), contiguous,
// filled at [head_offset, head_offset + n_anchors * gy * gx). cin must be a
// multiple of K4_KC and the head at most 4 * K4_THREADS channels. Launches
// on `stream`, allocates nothing, returns the CUDA error code (0 = success).
extern "C" int yolo_decode_packed_fused_head(
    const void* x, long long sb, long long sy, long long sx, int is_bf16,
    const void* w, const float* bias, int batch, int gy, int gx, int cin,
    int n_anchors, int n_classes, const float* anchors_wh, float stride,
    float prob_thresh, int head_offset, int n_total, float* payload,
    void* stream) {
  const int cout = n_anchors * (5 + n_classes);
  const int cpt = (cout + K4_THREADS - 1) / K4_THREADS;
  if (n_anchors < 1 || n_anchors > K1_MAX_ANCHORS || n_classes < 1 ||
      batch < 1 || gy < 1 || gx < 1 || cin < K4_KC || cin % K4_KC != 0 ||
      cpt > 4)
    return (int)cudaErrorInvalidValue;
  AnchorSet anchors;
  for (int i = 0; i < 2 * n_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_cpt<bf16_bits>(cpt, x, sb, sy, sx, w, bias, batch, gy,
                                   gx, cin, n_anchors, n_classes, anchors,
                                   stride, prob_thresh, head_offset, n_total,
                                   payload, s);
  return dispatch_cpt<float>(cpt, x, sb, sy, sx, w, bias, batch, gy, gx, cin,
                             n_anchors, n_classes, anchors, stride,
                             prob_thresh, head_offset, n_total, payload, s);
}
