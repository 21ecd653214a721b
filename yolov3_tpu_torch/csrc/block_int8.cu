// K6: fused int8 residual block (1x1 conv -> 3x3 conv -> shortcut), CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_block.py ::
// residual_block_int8 (body _block_kernel). One launch computes, for the
// int8 NHWC block input x (B, H, W, C) at scale s_in, in the order of the
// unfused int8-carrier walk (yolov3_tpu_torch/quant.py):
//
//   m1   = x . w1                      int32, w1 (C, cmid)
//   y1   = leaky(float(m1) * deq1 + b1)
//   mid  = clip(rint(y1 * inv_smid), +-127)        int8, zero outside image
//   m2   = conv3x3(mid, w2)            int32, w2 (9 * cmid, C), SAME padding
//   y2   = leaky(float(m2) * deq2 + b2)
//   y2   = clip(rint(y2 * inv_smid2), +-127) * smid2
//   y    = y2 + float(x) * s_in                    (linear shortcut)
//   out  = int8 clip(rint(y * inv_sout), +-127), or y as bf16 / float32.
//
// Nothing of the TPU kernel's layout is carried over: no padded chain
// layout, no 128-lane padding of cmid, no column rolls. The kernel reads the
// plain NHWC tensor and masks the image edges in its loads, so a chain of
// blocks is consecutive launches.
//
// Design. A thread block owns an 8x8 pixel tile of one image. It stages the
// 10x10xC int8 halo slab in shared memory (zero outside the image, 16-byte
// loads), computes the 10x10xcmid quantized mid tile into shared memory
// (masked to zero outside the image: that mask IS the 3x3's SAME padding),
// then the 3x3 from the mid tile and the epilogue. Both integer products
// are __dp4a dots over packed groups of four reduction elements: warp lanes
// own output channels (lane + 32k, four per 128-channel chunk), each warp
// owns eight pixels, so one weight word (read coalesced through L1/L2; w2 at
// C = 256 is 295 KB, over a block's shared memory) feeds eight dots and one
// broadcast 16-byte shared read feeds four reduction steps. The weights
// arrive packed by the wrapper: w1p[c/4][j] and w2p[(tap*cmid + j)/4][o] are
// 32-bit words of four consecutive reduction elements.
//
// What bounds it: operations. At yolov3@416 batch 8 one block is 14.2 G int8
// operations over 11-22 MB of activations; the int8 tensor cores would need
// about 7 us, a __dp4a kernel on the integer lanes cannot pass roughly
// 120 us. This is the simple right kernel; the tensor-core form is later
// work.
//
// Float contract: built with -fmad=false, rounding is rintf (half to even,
// what torch.round does), so every epilogue is the separate multiply, add,
// compare and round that eager PyTorch runs and the kernel equals its plain
// version (ops/cuda_block.py :: residual_block_int8_reference) exactly. That
// arithmetic (dequantize, leaky, requantize, the image-edge mask) lives in
// block_int8_common.cuh, where the ingredient probes of probe.cu run it too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_int8_common.cuh"

#define K6_TH 8
#define K6_TW 8
#define K6_HW (K6_TW + 2)
#define K6_HPX ((K6_TH + 2) * K6_HW)
#define K6_WARPS 8
#define K6_THREADS (K6_WARPS * 32)
#define K6_PX 8   // pixels per warp register tile
#define K6_CH 4   // channels per lane in a 128-channel chunk
#define K6_OUT_INT8 0
#define K6_OUT_BF16 1
#define K6_OUT_F32 2

struct K6Params {
  const int8_t* x;
  const int32_t* w1p;
  const int32_t* w2p;
  const float* deq1;
  const float* b1;
  const float* deq2;
  const float* b2;
  void* out;
  int batch, h, w, c, cmid;
  float inv_smid, inv_smid2, smid2, s_in, inv_sout;
};

extern __shared__ int4 k6_smem[];

template <int OUT_KIND>
__global__ void __launch_bounds__(K6_THREADS)
block_int8_kernel(const K6Params p) {
  int8_t* xs = reinterpret_cast<int8_t*>(k6_smem);   // [K6_HPX][c]
  int8_t* mid = xs + K6_HPX * p.c;                   // [K6_HPX][cmid]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * K6_TH, tx0 = blockIdx.x * K6_TW;
  const int c = p.c, cmid = p.cmid, h = p.h, w = p.w;
  const int vecs = c >> 4, mvecs = cmid >> 4;

  // ---- the halo slab, zero outside the image
  for (int i = tid; i < K6_HPX * vecs; i += K6_THREADS) {
    const int hp = i / vecs, v = i - hp * vecs;
    int gy, gx;
    k6_slab_coords(hp, K6_HW, ty0 - 1, tx0 - 1, &gy, &gx);
    int4 val = make_int4(0, 0, 0, 0);
    if (k6_in_image(gy, gx, h, w))
      val = __ldg(reinterpret_cast<const int4*>(
                      p.x + (((long long)b * h + gy) * w + gx) * c) + v);
    reinterpret_cast<int4*>(xs)[hp * vecs + v] = val;
  }
  __syncthreads();

  // ---- 1x1 -> dequant + bias + leaky -> quantize to s_mid, on all halo
  // pixels; a warp takes K6_PX pixels at a time
  for (int g = warp; g * K6_PX < K6_HPX; g += K6_WARPS) {
    const int p0 = g * K6_PX;
    for (int jc = 0; jc < cmid; jc += 32 * K6_CH) {
      int acc[K6_PX][K6_CH];
#pragma unroll
      for (int px = 0; px < K6_PX; ++px)
#pragma unroll
        for (int k = 0; k < K6_CH; ++k) acc[px][k] = 0;
      for (int c16 = 0; c16 < vecs; ++c16) {
        int4 xv[K6_PX];
#pragma unroll
        for (int px = 0; px < K6_PX; ++px) {
          const int hp = min(p0 + px, K6_HPX - 1);
          xv[px] = reinterpret_cast<const int4*>(xs)[hp * vecs + c16];
        }
        const int32_t* wrow = p.w1p + (long long)(c16 * 4) * cmid + jc + lane;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          int wv[K6_CH];
#pragma unroll
          for (int k = 0; k < K6_CH; ++k)
            wv[k] = jc + lane + 32 * k < cmid ? __ldg(wrow + s * cmid + 32 * k)
                                              : 0;
#pragma unroll
          for (int px = 0; px < K6_PX; ++px) {
            const int xw = s == 0 ? xv[px].x
                         : s == 1 ? xv[px].y
                         : s == 2 ? xv[px].z : xv[px].w;
#pragma unroll
            for (int k = 0; k < K6_CH; ++k)
              acc[px][k] = __dp4a(xw, wv[k], acc[px][k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K6_CH; ++k) {
        const int j = jc + lane + 32 * k;
        if (j >= cmid) continue;
        const float d = p.deq1[j], bb = p.b1[j];
#pragma unroll
        for (int px = 0; px < K6_PX; ++px) {
          const int hp = p0 + px;
          if (hp >= K6_HPX) continue;
          int q = 0;
          if (k6_slab_valid(hp, K6_HW, ty0 - 1, tx0 - 1, h, w))
            q = (int)k6_requant(k6_dequant_leaky(acc[px][k], d, bb),
                                p.inv_smid);
          mid[hp * cmid + j] = (int8_t)q;
        }
      }
    }
  }
  __syncthreads();

  // ---- 3x3 over the mid tile, then the epilogue; warp = tile row
  const int gy = ty0 + warp;
  if (gy >= h) return;
  for (int oc = 0; oc < c; oc += 32 * K6_CH) {
    int acc[K6_PX][K6_CH];
#pragma unroll
    for (int px = 0; px < K6_PX; ++px)
#pragma unroll
      for (int k = 0; k < K6_CH; ++k) acc[px][k] = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - ky * 3;
      const int hp0 = (warp + ky) * K6_HW + kx;
      for (int j16 = 0; j16 < mvecs; ++j16) {
        int4 mv[K6_PX];
#pragma unroll
        for (int px = 0; px < K6_PX; ++px)
          mv[px] = reinterpret_cast<const int4*>(mid)[(hp0 + px) * mvecs + j16];
        const int32_t* wrow =
            p.w2p + (long long)(tap * (cmid >> 2) + j16 * 4) * c + oc + lane;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          int wv[K6_CH];
#pragma unroll
          for (int k = 0; k < K6_CH; ++k)
            wv[k] = oc + lane + 32 * k < c ? __ldg(wrow + s * c + 32 * k) : 0;
#pragma unroll
          for (int px = 0; px < K6_PX; ++px) {
            const int mw = s == 0 ? mv[px].x
                         : s == 1 ? mv[px].y
                         : s == 2 ? mv[px].z : mv[px].w;
#pragma unroll
            for (int k = 0; k < K6_CH; ++k)
              acc[px][k] = __dp4a(mw, wv[k], acc[px][k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K6_CH; ++k) {
      const int o = oc + lane + 32 * k;
      if (o >= c) continue;
      const float d = p.deq2[o], bb = p.b2[o];
#pragma unroll
      for (int px = 0; px < K6_PX; ++px) {
        const int gx = tx0 + px;
        if (gx >= w) continue;
        // the 3x3 output quantizes to ITS scale before the shortcut
        // dequantizes it back, as in the unfused walk
        const float y2 = k6_requant(k6_dequant_leaky(acc[px][k], d, bb),
                                    p.inv_smid2) * p.smid2;
        const float xres =
            (float)xs[((warp + 1) * K6_HW + px + 1) * c + o] * p.s_in;
        const float y = y2 + xres;
        const long long at = (((long long)b * h + gy) * w + gx) * c + o;
        if (OUT_KIND == K6_OUT_INT8) {
          static_cast<int8_t*>(p.out)[at] =
              (int8_t)(int)k6_requant(y, p.inv_sout);
        } else if (OUT_KIND == K6_OUT_BF16) {
          static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(y);
        } else {
          static_cast<float*>(p.out)[at] = y;
        }
      }
    }
  }
}

template <int OUT_KIND>
static int launch_block(const K6Params& p, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_int8_kernel<OUT_KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.w + K6_TW - 1) / K6_TW, (p.h + K6_TH - 1) / K6_TH,
                  p.batch);
  block_int8_kernel<OUT_KIND><<<grid, K6_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// C entry (ctypes). x: int8 NHWC (batch, h, w, c) contiguous, 16-byte
// aligned, c % 16 == 0 and cmid % 16 == 0. w1p: (c/4, cmid) and w2p:
// (9*cmid/4, c) int32 words of four packed reduction elements. deq1/b1:
// (cmid,) float32, deq2/b2: (c,) float32. out: (batch, h, w, c) contiguous,
// int8 (out_kind 0), bf16 (1) or float32 (2). Launch on `stream`, allocate
// nothing, return cudaGetLastError().
extern "C" int yolo_residual_block_int8(
    const void* x, const void* w1p, const void* w2p, const float* deq1,
    const float* b1, const float* deq2, const float* b2, int batch, int h,
    int w, int c, int cmid, float inv_smid, float inv_smid2, float smid2,
    float s_in, float inv_sout, int out_kind, void* out, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || c < 16 || c % 16 ||
      cmid < 16 || cmid % 16 || (h + K6_TH - 1) / K6_TH > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K6_HPX * (c + cmid);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  K6Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w1p = static_cast<const int32_t*>(w1p);
  p.w2p = static_cast<const int32_t*>(w2p);
  p.deq1 = deq1;
  p.b1 = b1;
  p.deq2 = deq2;
  p.b2 = b2;
  p.out = out;
  p.batch = batch;
  p.h = h;
  p.w = w;
  p.c = c;
  p.cmid = cmid;
  p.inv_smid = inv_smid;
  p.inv_smid2 = inv_smid2;
  p.smid2 = smid2;
  p.s_in = s_in;
  p.inv_sout = inv_sout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case K6_OUT_INT8: return launch_block<K6_OUT_INT8>(p, smem, s);
    case K6_OUT_BF16: return launch_block<K6_OUT_BF16>(p, smem, s);
    case K6_OUT_F32: return launch_block<K6_OUT_F32>(p, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
