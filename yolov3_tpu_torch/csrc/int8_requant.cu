// The int8 walk's requantize pass, CUDA C++ for sm_90a:
//
//   v   <- act1(float(acc) * scale[c] + b[c])
//   v   <- act2(q3 * s3 + qr * sr),  q3 = q(v, 1 / s3)     (with a shortcut)
//   out <- q(v, 1 / s_out) as int8, or v as bf16 / float32
//
// over the int32 NHWC sums acc (B, H, W, C) of one int8 conv (ops/int8_conv.py:
// im2col + torch._int_mm), rows of C channels lda apart (lda > C where
// _int_mm's N was padded to a multiple of 8, as for a quantized head's 255),
// with scale the conv's per-channel dequantize scale (sw * float32(s_in)), b
// its bias, act1 its activation (leaky 0.1, linear, relu or mish) and q(f,
// inv) = clip(round-half-even(f * inv), -127, 127). Where a shortcut follows
// the conv and reads int8 (model.residual_convs), the pass also takes it: qr
// is the shortcut's other input at scale sr, s3 the conv's own output scale
// and act2 the shortcut's activation. The conv's int8 q3 is formed in
// registers and never written: its only reader was the shortcut. The output
// is int8 at s_out where every consumer reads int8, else the walk's float
// carrier (the convs before the float head convs).
//
// It replaces no TPU kernel: on the TPU, XLA fused this epilogue into
// lax.conv_general_dilated's int32 output. On the card PyTorch ran it as a
// chain of element-wise passes over the output, each a full float32 read and
// write: the int32 -> float32 cast, x scale, + b, leaky_relu, x 1/s_out,
// round, clamp, the int8 cast; and for a shortcut both operands' casts and
// products, the add, and one more quantize. This kernel is that chain in one
// read of acc (and of qr) and one write of the output.
//
// What bounds it on the H100: bytes, 4 (int32) + 1 (qr) + 1 (int8 out)
// bytes an element at HBM's rate; the arithmetic is a few flops an element.
// So a thread takes 8 channels of a pixel: two 16-byte loads of int32 on the
// read-only path, the 8 channels' scales and biases in registers from four
// 16-byte loads, and one whole 8-byte int8 store (16 or 32 bytes for bf16 /
// float32). No division or modulo in the loop, 64-bit indexes (a batch of 32
// at 304 x 304 x 64 holds 189 M elements). A block is threads_x x threads_y
// threads: lane x of block column bx owns the channels [8 (threads_x bx +
// x), + 8), and row thread y of block row by takes the pixels by * threads_y
// + y, then a stride of gridDim.y * threads_y on (ops/cuda_requant.py
// plan_int8_requant: threads_x covers a row's pieces, up to 256, so a warp
// reads consecutive pieces across pixels). Where C is not a multiple of 8 or
// a tensor (or lda) is off the 16-byte grid the same walk takes one element a
// thread. Where act1 or act2 is mish the walk runs in a kernel of its own,
// int8_requant_mish_kernel, so that the leaky and linear kernel's code does
// not change with it. Measured on the card at yolov3@608 B=32 (51 passes),
// in a design experiment not kept in the repository: loading the scales and
// biases one float at a time cost 30% of the bound (3.96 ms against 2.71
// with 16-byte loads); 8 channels a thread beat 16 by 2-5%.
//
// Rounding: the result is bit-identical to the PyTorch chain it replaces.
// Each step rounds where PyTorch's kernels round, with explicit intrinsics
// (and -fmad=false): __int2float_rn, __fmul_rn by scale, __fadd_rn of b;
// leaky as v > 0 ? v : v * 0.1f, relu and mish as the float walk's epilogue
// computes them (csrc/conv_epilogue.cu); at a quantize site __fmul_rn by
// float32(1 / s), rintf (half to even, torch.round), then the clip (the site
// K6's k6_round_clip computes); the shortcut's two products and their sum
// each rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define RQ_THREADS 256
#define RQ_VEC 8  // channels a thread on the vector path
#define RQ_MAX_ELEMENTS (1LL << 62)

enum { RQ_LINEAR = 0, RQ_LEAKY = 1, RQ_RELU = 2, RQ_MISH = 3 };
enum { RQ_INT8 = 0, RQ_BF16 = 1, RQ_FLOAT32 = 2 };

// the float constants of a launch: the output's 1 / s_out and, with a
// shortcut, the conv's s3 and 1 / s3 and the residual's sr (each a double
// rounded once to float32, as PyTorch rounds a Python scalar)
struct RqScales {
  float inv_out, s3, inv_s3, sr;
};

// PyTorch's CUDA leaky_relu (negval as float), relu (clamp_min: NaN kept)
// and, in the mish kernel, mish (ActivationMishKernel.cu: float opmath, no
// threshold), or linear
template <bool MISH>
__device__ __forceinline__ float rq_act(float v, int act) {
  if (act == RQ_LEAKY) return v > 0.0f ? v : __fmul_rn(v, 0.1f);
  if (act == RQ_RELU) return isnan(v) ? v : fmaxf(v, 0.0f);
  if (MISH && act == RQ_MISH) return v * tanhf(log1pf(expf(v)));
  return v;
}

// clip(round-half-even(f), -127, 127): torch.clamp(torch.round(f), ±127)
__device__ __forceinline__ float rq_round_clip(float f) {
  return fminf(fmaxf(rintf(f), -127.0f), 127.0f);
}

// one element up to the value the output site receives
template <bool RES, bool MISH>
__device__ __forceinline__ float rq_value(int acc, float scale, float bias,
                                          int qr, int act1, int act2,
                                          const RqScales& k) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  v = rq_act<MISH>(v, act1);
  if (RES) {
    const float q3 = rq_round_clip(__fmul_rn(v, k.inv_s3));
    v = __fadd_rn(__fmul_rn(q3, k.s3), __fmul_rn(__int2float_rn(qr), k.sr));
    v = rq_act<MISH>(v, act2);
  }
  return v;
}

// the output site: int8 at 1 / s_out, or the float carrier
template <typename OutT>
__device__ __forceinline__ OutT rq_out(float v, float inv_out);
template <>
__device__ __forceinline__ int8_t rq_out<int8_t>(float v, float inv_out) {
  return (int8_t)__float2int_rn(rq_round_clip(__fmul_rn(v, inv_out)));
}
template <>
__device__ __forceinline__ __nv_bfloat16 rq_out<__nv_bfloat16>(float v,
                                                               float) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float rq_out<float>(float v, float) {
  return v;
}

// the walk both kernels run: a piece of 8 channels (or one element) of a
// row a thread, the rows strided over grid y
template <typename OutT, bool VEC, bool RES, bool MISH>
__device__ __forceinline__ void rq_walk(const int* __restrict__ acc,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        const int8_t* __restrict__ qr,
                                        OutT* __restrict__ out,
                                        long long rows, long long c,
                                        long long lda, int act1, int act2,
                                        const RqScales& k) {
  constexpr int V = VEC ? RQ_VEC : 1;
  const long long c0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c0 >= c) return;
  float s[V], b[V];
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      reinterpret_cast<float4*>(s)[j] =
          __ldg(reinterpret_cast<const float4*>(scale + c0) + j);
      reinterpret_cast<float4*>(b)[j] =
          __ldg(reinterpret_cast<const float4*>(bias + c0) + j);
    }
  } else {
    s[0] = scale[c0];
    b[0] = bias[c0];
  }
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long row = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       row < rows; row += step) {
    const long long i = row * c + c0;
    const long long ia = row * lda + c0;
    if constexpr (VEC) {
      // V outputs: 8 bytes of int8 (one uint2), 16 of bf16, 32 of float32
      using Chunk =
          typename std::conditional<sizeof(OutT) == 1, uint2, uint4>::type;
      constexpr int kChunks = V * (int)sizeof(OutT) / (int)sizeof(Chunk);
      int4 a[V / 4];
#pragma unroll
      for (int j = 0; j < V / 4; ++j)
        a[j] = __ldg(reinterpret_cast<const int4*>(acc + ia) + j);
      uint2 r = make_uint2(0, 0);
      if (RES) r = *reinterpret_cast<const uint2*>(qr + i);
      const int* av = reinterpret_cast<const int*>(a);
      const int8_t* rv = reinterpret_cast<const int8_t*>(&r);
      Chunk o[kChunks];
      OutT* ov = reinterpret_cast<OutT*>(o);
#pragma unroll
      for (int e = 0; e < V; ++e)
        ov[e] = rq_out<OutT>(
            rq_value<RES, MISH>(av[e], s[e], b[e], rv[e], act1, act2, k),
            k.inv_out);
      Chunk* dst = reinterpret_cast<Chunk*>(out + i);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) dst[j] = o[j];
    } else {
      out[i] = rq_out<OutT>(rq_value<RES, MISH>(acc[ia], s[0], b[0],
                                                RES ? qr[i] : 0, act1, act2,
                                                k),
                            k.inv_out);
    }
  }
}

template <typename OutT, bool VEC, bool RES>
__global__ void __launch_bounds__(RQ_THREADS)
    int8_requant_kernel(const int* __restrict__ acc,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const int8_t* __restrict__ qr,
                        OutT* __restrict__ out, long long rows, long long c,
                        long long lda, int act1, int act2, RqScales k) {
  rq_walk<OutT, VEC, RES, false>(acc, scale, bias, qr, out, rows, c, lda,
                                 act1, act2, k);
}

template <typename OutT, bool VEC, bool RES>
__global__ void __launch_bounds__(RQ_THREADS)
    int8_requant_mish_kernel(const int* __restrict__ acc,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             const int8_t* __restrict__ qr,
                             OutT* __restrict__ out, long long rows,
                             long long c, long long lda, int act1, int act2,
                             RqScales k) {
  rq_walk<OutT, VEC, RES, true>(acc, scale, bias, qr, out, rows, c, lda,
                                act1, act2, k);
}

template <typename OutT, bool VEC, bool RES>
static void launch_res(bool mish, const int* acc, const float* scale,
                       const float* bias, const int8_t* qr, OutT* out,
                       long long rows, long long c, long long lda, int act1,
                       int act2, RqScales k, dim3 grid, dim3 block,
                       cudaStream_t s) {
  if (mish)
    int8_requant_mish_kernel<OutT, VEC, RES><<<grid, block, 0, s>>>(
        acc, scale, bias, qr, out, rows, c, lda, act1, act2, k);
  else
    int8_requant_kernel<OutT, VEC, RES><<<grid, block, 0, s>>>(
        acc, scale, bias, qr, out, rows, c, lda, act1, act2, k);
}

template <typename OutT, bool VEC>
static void launch(bool mish, const void* acc, const void* scale,
                   const void* bias, const void* qr, void* out,
                   long long rows, long long c, long long lda, int act1,
                   int act2, RqScales k, dim3 grid, dim3 block,
                   cudaStream_t s) {
  const int* a = static_cast<const int*>(acc);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  OutT* o = static_cast<OutT*>(out);
  if (qr)
    launch_res<OutT, VEC, true>(mish, a, sc, b,
                                static_cast<const int8_t*>(qr), o, rows, c,
                                lda, act1, act2, k, grid, block, s);
  else
    launch_res<OutT, VEC, false>(mish, a, sc, b, nullptr, o, rows, c, lda,
                                 act1, act2, k, grid, block, s);
}

template <typename OutT>
static void launch_vec(int vec, bool mish, const void* acc,
                       const void* scale, const void* bias, const void* qr,
                       void* out, long long rows, long long c, long long lda,
                       int act1, int act2, RqScales k, dim3 grid, dim3 block,
                       cudaStream_t s) {
  if (vec)
    launch<OutT, true>(mish, acc, scale, bias, qr, out, rows, c, lda, act1,
                       act2, k, grid, block, s);
  else
    launch<OutT, false>(mish, acc, scale, bias, qr, out, rows, c, lda, act1,
                        act2, k, grid, block, s);
}

static bool rq_off_grid(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 != 0;
}

// acc (rows, c) int32, rows lda >= c apart; scale, bias (c,) float32; qr
// (rows, c) dense int8, or null (no shortcut); out (rows, c) dense of
// out_type (RQ_INT8, RQ_BF16, RQ_FLOAT32); act1 / act2 RQ_LINEAR, RQ_LEAKY,
// RQ_RELU or RQ_MISH (the mish kernel where either is); inv_out the
// output's float32(1 / s_out) (read at RQ_INT8 only); s3, inv_s3, sr the
// shortcut's (read with qr only); a (grid_x, grid_y) grid of threads_x x
// threads_y blocks (ops/cuda_requant.py plan_int8_requant), grid_x *
// threads_x pieces covering a row; vec: c a multiple of 8, lda of 4, and
// acc, scale, bias, qr, out on the 16-byte grid, else one element a thread.
extern "C" int yolo_int8_requant(const void* acc, const void* scale,
                                 const void* bias, const void* qr, void* out,
                                 long long rows, long long c, long long lda,
                                 int out_type,
                                 int act1, int act2, float inv_out, float s3,
                                 float inv_s3, float sr, int vec,
                                 int threads_x, int threads_y, int grid_x,
                                 int grid_y, void* stream) {
  const int v = vec ? RQ_VEC : 1;
  if (!acc || !scale || !bias || !out || rows < 1 || c < 1 ||
      lda < c || lda > RQ_MAX_ELEMENTS / rows || out_type < RQ_INT8 ||
      out_type > RQ_FLOAT32 || act1 < RQ_LINEAR || act1 > RQ_MISH ||
      act2 < RQ_LINEAR || act2 > RQ_MISH || threads_x < 1 ||
      threads_y < 1 || threads_x * threads_y > RQ_THREADS || grid_x < 1 ||
      (long long)grid_x * threads_x * v < c || grid_y < 1 ||
      grid_y > 65535 ||
      (vec && (c % v || lda % 4 || rq_off_grid(acc) || rq_off_grid(scale) ||
               rq_off_grid(bias) || rq_off_grid(out) ||
               (qr && rq_off_grid(qr)))))
    return (int)cudaErrorInvalidValue;
  const RqScales k = {inv_out, s3, inv_s3, sr};
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const dim3 block((unsigned)threads_x, (unsigned)threads_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mish = act1 == RQ_MISH || (qr && act2 == RQ_MISH);
  if (out_type == RQ_INT8)
    launch_vec<int8_t>(vec, mish, acc, scale, bias, qr, out, rows, c, lda,
                       act1, act2, k, grid, block, s);
  else if (out_type == RQ_BF16)
    launch_vec<__nv_bfloat16>(vec, mish, acc, scale, bias, qr, out, rows, c,
                              lda, act1, act2, k, grid, block, s);
  else
    launch_vec<float>(vec, mish, acc, scale, bias, qr, out, rows, c, lda,
                      act1, act2, k, grid, block, s);
  return (int)cudaGetLastError();
}
