// The float walk's conv epilogue, CUDA C++ for sm_90a:
//
//   y <- act2(act1(y + b) + r)
//
// over a dense NHWC tensor y (B, H, W, C): the output of one cuDNN conv, in
// place, with b the conv's per-channel bias, act1 its activation (leaky 0.1,
// linear or relu), and, where a shortcut follows the conv, r the shortcut's
// other input (same shape) and act2 the shortcut's activation. Without r the
// pass stops after act1.
//
// It replaces no TPU kernel: on the TPU, XLA fused the bias, the activation
// and the shortcut's add into the conv. On the card PyTorch runs cuDNN's conv
// without its bias and then three element-wise passes over the output: the
// bias add (a broadcast, which takes it off PyTorch's vectorised path),
// F.leaky_relu and the shortcut's add. This kernel is those three passes in
// one: one read of y, one read of r, one write.
//
// What bounds it on the H100: bytes, 2 (or 3 with r) x the output at HBM's
// rate; the arithmetic is a few flops an element. So every thread moves one
// 16-byte piece a row (8 bf16 or 4 float32 channels: VEC) and keeps the
// piece's biases in registers: no division or modulo in the loop, 64-bit
// indexes (a batch of 32 at 608 x 608 holds 378 M elements in one tensor).
// A block is threads_x x threads_y threads: lane x of block column bx owns
// the channels [V (threads_x bx + x), + V), and row thread y of block row by
// takes the pixels by * threads_y + y, then a stride of gridDim.y *
// threads_y on (ops/cuda_epilogue.py plan_conv_epilogue: threads_x covers a
// row's pieces, up to 256, so a warp reads consecutive 16-byte pieces across
// pixels). Where C is not a multiple of V or a pointer is off the 16-byte
// grid (the 255-channel heads), the same walk takes one element a thread.
//
// Rounding: the result is bit-identical to the PyTorch chain it replaces, in
// bf16 and in float32. Each step computes in float32 and rounds to the
// element type where PyTorch's kernels round: after y + b (add_, float
// opmath), after act1 (leaky_relu: a > 0 ? a : a * 0.1f), after + r, after
// act2. Built with -fmad=false: a * 0.1f + r must not contract into an FMA.
// One rounding at the end would be more accurate and a different result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CE_THREADS 256
#define CE_MAX_ELEMENTS (1LL << 62)

enum { CE_LINEAR = 0, CE_LEAKY = 1, CE_RELU = 2 };

__device__ __forceinline__ float ce_float(float v) { return v; }
__device__ __forceinline__ float ce_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T ce_round(float v);
template <>
__device__ __forceinline__ float ce_round<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 ce_round<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// PyTorch's CUDA leaky_relu (negval as float) and relu (clamp_min: NaN kept)
__device__ __forceinline__ float ce_act(float v, int act) {
  if (act == CE_LEAKY) return v > 0.0f ? v : v * 0.1f;
  if (act == CE_RELU) return isnan(v) ? v : fmaxf(v, 0.0f);
  return v;
}

template <typename T, bool RES>
__device__ __forceinline__ T ce_one(T y, float b, T r, int act1, int act2) {
  T v = ce_round<T>(ce_float(y) + b);
  v = ce_round<T>(ce_act(ce_float(v), act1));
  if (RES) {
    v = ce_round<T>(ce_float(v) + ce_float(r));
    v = ce_round<T>(ce_act(ce_float(v), act2));
  }
  return v;
}

template <typename T, bool VEC, bool RES>
__global__ void __launch_bounds__(CE_THREADS)
    conv_epilogue_kernel(T* __restrict__ y, const T* __restrict__ bias,
                         const T* __restrict__ r, long long rows,
                         long long c, int act1, int act2) {
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  const long long c0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c0 >= c) return;
  float b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b[e] = ce_float(bias[c0 + e]);
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long row = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       row < rows; row += step) {
    const long long i = row * c + c0;
    if (VEC) {
      uint4 piece = *reinterpret_cast<const uint4*>(y + i);
      uint4 res = make_uint4(0, 0, 0, 0);
      if (RES) res = *reinterpret_cast<const uint4*>(r + i);
      T* v = reinterpret_cast<T*>(&piece);
      const T* s = reinterpret_cast<const T*>(&res);
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[e] = ce_one<T, RES>(v[e], b[e], s[e], act1, act2);
      *reinterpret_cast<uint4*>(y + i) = piece;
    } else {
      y[i] = ce_one<T, RES>(y[i], b[0], RES ? r[i] : y[i], act1, act2);
    }
  }
}

template <typename T, bool VEC>
static void launch(void* y, const void* bias, const void* r,
                   long long rows, long long c, int act1, int act2,
                   dim3 grid, dim3 block, cudaStream_t s) {
  if (r)
    conv_epilogue_kernel<T, VEC, true><<<grid, block, 0, s>>>(
        static_cast<T*>(y), static_cast<const T*>(bias),
        static_cast<const T*>(r), rows, c, act1, act2);
  else
    conv_epilogue_kernel<T, VEC, false><<<grid, block, 0, s>>>(
        static_cast<T*>(y), static_cast<const T*>(bias), nullptr, rows, c,
        act1, act2);
}

static bool ce_off_grid(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 != 0;
}

// y (rows, c) dense, bf16 (is_bf16) or float32, rewritten in place; bias (c,)
// of y's type; r (rows, c) dense of y's type, or null; act1 / act2 CE_*; a
// (grid_x, grid_y) grid of threads_x x threads_y blocks
// (ops/cuda_epilogue.py plan_conv_epilogue), grid_x * threads_x pieces
// covering a row; vec: c a multiple of the 16-byte piece and y, r on the
// 16-byte grid, else one element a thread.
extern "C" int yolo_conv_epilogue(void* y, const void* bias, const void* r,
                                  long long rows, long long c, int is_bf16,
                                  int act1, int act2, int vec, int threads_x,
                                  int threads_y, int grid_x, int grid_y,
                                  void* stream) {
  const int v = vec ? (is_bf16 ? 8 : 4) : 1;
  if (rows < 1 || c < 1 || c > CE_MAX_ELEMENTS / rows || act1 < 0 ||
      act1 > CE_RELU || act2 < 0 || act2 > CE_RELU || threads_x < 1 ||
      threads_y < 1 || threads_x * threads_y > CE_THREADS || grid_x < 1 ||
      (long long)grid_x * threads_x * v < c || grid_y < 1 ||
      grid_y > 65535 ||
      (vec && (c % v || ce_off_grid(y) || (r && ce_off_grid(r)))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const dim3 block((unsigned)threads_x, (unsigned)threads_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec)
      launch<__nv_bfloat16, true>(y, bias, r, rows, c, act1, act2, grid,
                                  block, s);
    else
      launch<__nv_bfloat16, false>(y, bias, r, rows, c, act1, act2, grid,
                                   block, s);
  } else {
    if (vec)
      launch<float, true>(y, bias, r, rows, c, act1, act2, grid, block, s);
    else
      launch<float, false>(y, bias, r, rows, c, act1, act2, grid, block, s);
  }
  return (int)cudaGetLastError();
}
