// K6: fused int8 residual block (1x1 conv -> 3x3 conv -> shortcut), CUDA C++
// for sm_90a, both integer products on Hopper's int8 tensor cores (wgmma
// m64nNk32.s32.s8.s8, exact int32 sums).
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
// Design. A thread block owns a TH x 8 tile of output pixels of one image
// (TH = 8: one warpgroup; TH = 16: two, each owning 8 tile rows = 64
// pixels; the caller's plan picks it). Its copies, all 16-byte cp.async:
//   x halo  the (TH + 2) x 10 pixels around the tile, C channels, as C / 128
//           tiles of 128-byte rows in the 128-byte swizzle (rows padded to a
//           multiple of 64: 128 or 192); pixels outside the image and the
//           padding rows are zero-filled by source size 0;
//   w1      [cmid_p][C] K-major, the same swizzle (cmid_p = cmid rounded up
//           to 64; the wrapper zero-fills rows past cmid);
//   w2      [C][9 * cmid_p] K-major (K = tap * cmid_p + mid channel, zero
//           past cmid and past 9 * cmid_p), streamed through a ring of
//           K6_STAGES steps of 128 bytes of K: one swizzled [C][128 B] tile
//           a step, 32 KB at C = 256. w2 is 295 KB at C = 256, more than a
//           block's shared memory, so every block reads all of it from L2.
// The 1x1 is one GEMM of M = the halo rows, N = cmid_p (in 64-column
// chunks), K = C on wgmma m64n64k32, warpgroups taking (64-row, 64-column)
// items in turn. Its epilogue, k6_dequant_leaky -> k6_requant, masked by
// the image edge (k6_slab_valid: that mask IS the 3x3's SAME padding),
// writes the int8 mid tile to shared memory WITHOUT swizzle as
// [cmid_p / 16][halo pixel][16 B]: eight consecutive pixels of a 16-channel
// plane are one 8 x 16-byte core matrix of a wgmma operand. The 3x3 is an
// implicit GEMM of M = the warpgroup's 64 pixels, N = C (one m64nCk32
// product), K = 9 * cmid_p: for tap (ky, kx) and channels j .. j + 31 the A
// operand is the mid tile itself, read through a no-swizzle descriptor
// whose start is offset by (ky * 10 + kx) pixels, whose stride byte offset
// (between 8-pixel groups) is one halo row, 10 * 16 B, and whose leading
// byte offset (between the two 16-channel planes of a product) is one
// plane, halo pixels * 16 B. No tap copies the mid tile. The epilogue
// (k6_dequant_leaky -> k6_requant * smid2, + x * s_in from the staged halo)
// runs on the wgmma fragment and writes pairs of channels straight to
// device memory. The products' int32 sums are exact (127 * 127 * 2,304 at
// K = 9 * 256 is about 3.7e7 < 2^31), so no float32 promotion.
//
// What bounds it: operations, at the card's peak. At yolov3@416 batch 8
// one block of C = 256 is 14.2 G int8 operations (7.2 us at 1,979 TOP/s)
// over 11 MB of activations (3.3 us at 3.35 TB/s). What holds it back
// (tools/ablate_block.py times the kernel with each part taken out): not
// the w2 stream from L2 (224 tiles x 295 KB at 52 x 52 C = 256), which the
// ring hides, but the work that overlaps no product: the copies and the
// 1x1 with its epilogue before the 3x3, and the 3x3's epilogue, some 25
// float operations an output issued by the block's own warps, after it.
// Each K step waits for its products before the next is issued (no
// accumulator in flight across the loop's back-edge, so ptxas never
// serialises the wgmmas); 224 tiles are 1.7 waves on 132 multiprocessors.
//
// Float contract: built with -fmad=false, rounding is half to even (what
// torch.round does; k6_round_clip equals rintf's), so every epilogue is the
// separate multiply, add, compare and round that eager PyTorch runs and the
// kernel equals its plain version (ops/cuda_block.py ::
// residual_block_int8_reference) exactly. That arithmetic (dequantize, leaky,
// requantize, the exact small int <-> float moves, the image-edge mask)
// lives in block_int8_common.cuh, where the ingredient probes of probe.cu
// run it too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_int8_common.cuh"
#include "wgmma_common.cuh"

#define K6_TW 8             // tile width: one core matrix of 8 pixels
#define K6_HW (K6_TW + 2)   // halo width
#define K6_STAGES 3         // w2 K steps in the ring: one used, two in flight
#define K6_KSTEP 128        // bytes of K a w2 step: one swizzled tile row
#define K6_N1 64            // columns of a 1x1 product
#define K6_SMEM_LIMIT 232448
#define K6_OUT_INT8 0
#define K6_OUT_BF16 1
#define K6_OUT_F32 2

// halo pixels of a tile of th rows, and the rows the 1x1 GEMM runs on
__host__ __device__ constexpr int k6_halo_px(int th) {
  return (th + 2) * K6_HW;
}
__host__ __device__ constexpr int k6_halo_rows(int th) {
  return (k6_halo_px(th) + 63) / 64 * 64;
}
__host__ __device__ constexpr int k6_cmid_padded(int cmid) {
  return (cmid + K6_N1 - 1) / K6_N1 * K6_N1;
}
// w2 K steps: 9 * cmid_p bytes of K in 128-byte steps
__host__ __device__ constexpr int k6_ksteps(int cmid_p) {
  return (9 * cmid_p + K6_KSTEP - 1) / K6_KSTEP;
}
// dynamic shared memory of a block (ops/cuda_block.py :: block_smem_bytes
// is the same sum): slack to a 1,024-byte boundary, the x halo, w1, the w2
// ring, the mid tile, then deq1 / b1 (cmid_p) and deq2 / b2 (C) as float32
__host__ __device__ constexpr int k6_smem_bytes(int th, int c, int cmid_p) {
  return 1024 + c * k6_halo_rows(th) + cmid_p * c + K6_STAGES * c * K6_KSTEP +
         cmid_p * k6_halo_px(th) + 4 * (2 * cmid_p + 2 * c);
}

struct K6Params {
  const int8_t* x;
  const int8_t* w1;   // (cmid_p, C)
  const int8_t* w2;   // (C, ksteps * 128)
  const float* deq1;
  const float* b1;
  const float* deq2;
  const float* b2;
  void* out;
  int batch, h, w, cmid, cmid_p, ksteps, out_kind;
  float inv_smid, inv_smid2, smid2, s_in, inv_sout;
};

template <int NWG, int C>
__global__ void __launch_bounds__(NWG * 128, C == 128 ? 2 : 1)
block_int8_kernel(const K6Params p) {
  constexpr int TH = NWG * 8;
  constexpr int THREADS = NWG * 128;
  constexpr int HPX = k6_halo_px(TH);
  constexpr int HROWS = k6_halo_rows(TH);
  constexpr int CV = C / 16;  // 16-byte chunks of a pixel / of a w1 row
  extern __shared__ unsigned char k6_smem[];
  const uint32_t raw = wg_smem_u32(k6_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = k6_smem + (base - raw);
  const int cmid_p = p.cmid_p;
  // every region but the mid tile and the floats starts on 1,024 bytes
  const uint32_t xs = base;                          // [C/128][HROWS][128]
  const uint32_t w1s = xs + C * HROWS;               // [C/128][cmid_p][128]
  const uint32_t ring = w1s + cmid_p * C;            // [STAGES][C][128]
  // [cmid_p / 16][HPX][16], no swizzle
  const uint32_t mids = ring + K6_STAGES * C * K6_KSTEP;
  unsigned char* const mid_ptr = base_ptr + (mids - base);
  float* const sdeq1 = reinterpret_cast<float*>(mid_ptr + cmid_p * HPX);
  float* const sb1 = sdeq1 + cmid_p;
  float* const sdeq2 = sb1 + cmid_p;
  float* const sb2 = sdeq2 + C;

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int wg = tid >> 7;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * K6_TW;
  const int h = p.h, w = p.w;

  // ---- copies: the x halo and w1 (one group), then the first w2 steps
  for (int i = tid; i < HROWS * CV; i += THREADS) {
    const int hp = i / CV, j = i - hp * CV;
    int gy, gx;
    k6_slab_coords(hp, K6_HW, ty0 - 1, tx0 - 1, &gy, &gx);
    const bool ok = hp < HPX && k6_in_image(gy, gx, h, w);
    wg_cp_async16(
        xs + (j >> 3) * (HROWS * WG_ROW) + hp * WG_ROW +
            (((j & 7) ^ (hp & 7)) << 4),
        ok ? p.x + (((long long)b * h + gy) * w + gx) * C + j * 16 : p.x,
        ok ? 16 : 0);
  }
  for (int i = tid; i < cmid_p * CV; i += THREADS) {
    const int n = i / CV, j = i - n * CV;
    wg_cp_async16(w1s + (j >> 3) * (cmid_p * WG_ROW) + n * WG_ROW +
                      (((j & 7) ^ (n & 7)) << 4),
                  p.w1 + (long long)n * C + j * 16, 16);
  }
  wg_cp_async_commit();
  // w2 step `ld` into ring stage `st` as one cp.async group; past the last
  // step an empty group keeps the count of groups in step with the loop
  const long long w2_row = (long long)p.ksteps * K6_KSTEP;
  int ld = 0;
  auto load_w2 = [&](int st) {
    if (ld < p.ksteps) {
      const uint32_t dst = ring + st * (C * K6_KSTEP);
      const int8_t* src = p.w2 + ld * K6_KSTEP;
#pragma unroll
      for (int it = 0; it < C * 8 / THREADS; ++it) {
        const int i = tid + it * THREADS, o = i >> 3, jj = i & 7;
        wg_cp_async16(dst + o * K6_KSTEP + ((jj ^ (o & 7)) << 4),
                      src + o * w2_row + jj * 16, 16);
      }
      ++ld;
    }
    wg_cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < K6_STAGES - 1; ++st) load_w2(st);
  for (int i = tid; i < cmid_p; i += THREADS) {
    const bool in = i < p.cmid;
    sdeq1[i] = in ? p.deq1[i] : 0.0f;
    sb1[i] = in ? p.b1[i] : 0.0f;
  }
  for (int i = tid; i < C; i += THREADS) {
    sdeq2[i] = p.deq2[i];
    sb2[i] = p.b2[i];
  }
  // the halo and w1 have landed (the w2 steps may still be in flight)
  wg_cp_async_wait<K6_STAGES - 1>();
  wg_fence_async_proxy();
  __syncthreads();

  // ---- the 1x1 on every halo row -> dequant + bias + leaky -> quantize to
  // s_mid, zero outside the image -> the mid tile. Fragment of m64n64:
  // warp w holds rows 16 w + lane / 4 (+ 8), columns 8 nb + 2 (lane % 4)
  // (+ 1) in acc[4 nb + 2 hr + e].
  const int nch = cmid_p / K6_N1;
  const int items = (HROWS / 64) * nch;
  for (int item = wg; item < items; item += NWG) {
    const int mc = item / nch, nc = item - mc * nch;
    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < C / 128; ++kt) {
      const uint64_t da =
          wg_desc(xs + kt * (HROWS * WG_ROW) + mc * (64 * WG_ROW));
      const uint64_t db =
          wg_desc(w1s + kt * (cmid_p * WG_ROW) + nc * (K6_N1 * WG_ROW));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 32 bytes of K a product
        wg_mma_m64k32_s8<K6_N1>(acc, da + 2 * kk, db + 2 * kk, 1);
    }
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int hp = mc * 64 + warp * 16 + (lane >> 2) + hr * 8;
      if (hp >= HPX) continue;
      const bool valid = k6_slab_valid(hp, K6_HW, ty0 - 1, tx0 - 1, h, w);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int j = nc * K6_N1 + nb * 8 + (lane & 3) * 2;
        int q0 = 0, q1 = 0;
        if (valid && j < p.cmid) {
          q0 = k6_level_int(k6_requant(
              k6_dequant_leaky(acc[nb * 4 + hr * 2], sdeq1[j], sb1[j]),
              p.inv_smid));
          q1 = k6_level_int(k6_requant(
              k6_dequant_leaky(acc[nb * 4 + hr * 2 + 1], sdeq1[j + 1],
                               sb1[j + 1]),
              p.inv_smid));
        }
        *reinterpret_cast<uint16_t*>(mid_ptr + (j >> 4) * (HPX * 16) +
                                     hp * 16 + (j & 15)) =
            (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
  }
  // the mid tile, written through the generic proxy, is read by wgmma
  wg_fence_async_proxy();
  __syncthreads();

  // ---- the 3x3: 9 taps x cmid_p channels of K through the w2 ring. The
  // warpgroup's output rows wg * 8 .. + 7 are A rows 8 r + c; at tap
  // (ky, kx) they read halo pixel (wg * 8 + r + ky) * 10 + c + kx.
  int acc2[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc2[i] = 0;
  const uint32_t lbo = HPX * 16;  // one 16-channel plane of the mid tile
  const uint32_t a_rows = mids + wg * 8 * K6_HW * 16;
  int st = 0;
  for (int s = 0; s < p.ksteps; ++s) {
    // step s has landed: this thread's copies, then everyone's; the barrier
    // also says every warpgroup is done with step s - 1's products
    wg_cp_async_wait<K6_STAGES - 2>();
    wg_fence_async_proxy();
    __syncthreads();
    const uint64_t db = wg_desc(ring + st * (C * K6_KSTEP));
    wg_fence_acc(acc2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < K6_KSTEP / 32; ++kk) {
      const int kg = s * K6_KSTEP + kk * 32;  // tap * cmid_p + channel
      int tap = kg / cmid_p, j0 = kg - tap * cmid_p;
      // past 9 * cmid_p the w2 rows are zero: any in-tile A adds nothing
      if (tap > 8) {
        tap = 8;
        j0 = 0;
      }
      const int ky = tap / 3, kx = tap - ky * 3;
      const uint64_t da = wg_desc_plain(
          a_rows + (j0 >> 4) * lbo + (ky * K6_HW + kx) * 16, lbo, K6_HW * 16);
      wg_mma_m64k32_s8<C>(acc2, da, db + 2 * kk, 1);
    }
    wg_commit();
    // while the products run: step s + K6_STAGES - 1 into the stage step
    // s - 1 has left
    load_w2(st == 0 ? K6_STAGES - 1 : st - 1);
    wg_wait<0>();
    wg_fence_acc(acc2);
    st = st + 1 == K6_STAGES ? 0 : st + 1;
  }
  wg_cp_async_wait<0>();  // the groups still open are empty

  // ---- epilogue on the m64nC fragment, two channels at a time
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = warp * 16 + (lane >> 2) + hr * 8;  // 0 .. 63
    const int ty = wg * 8 + (r >> 3), tx = r & 7;
    const int gy = ty0 + ty, gx = tx0 + tx;
    if (gy >= h || gx >= w) continue;
    const int hp = (ty + 1) * K6_HW + tx + 1;  // the pixel in the x halo
    const long long at = (((long long)b * h + gy) * w + gx) * C;
#pragma unroll
    for (int nb = 0; nb < C / 8; ++nb) {
      const int o = nb * 8 + (lane & 3) * 2;
      // channels o, o + 1 of the swizzled halo row: one 16-bit read
      const uint16_t xv = *reinterpret_cast<const uint16_t*>(
          base_ptr + (o >> 7) * (HROWS * WG_ROW) + hp * WG_ROW +
          ((((o & 127) >> 4) ^ (hp & 7)) << 4) + (o & 15));
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the 3x3 output quantizes to ITS scale before the shortcut
        // dequantizes it back, as in the unfused walk
        const float y2 = k6_requant(k6_dequant_leaky(acc2[nb * 4 + hr * 2 + e],
                                                     sdeq2[o + e], sb2[o + e]),
                                    p.inv_smid2) *
                         p.smid2;
        const float xres = k6_small_float((int8_t)(xv >> (8 * e))) * p.s_in;
        y[e] = y2 + xres;
      }
      if (p.out_kind == K6_OUT_INT8) {
        const int q0 = k6_level_int(k6_requant(y[0], p.inv_sout));
        const int q1 = k6_level_int(k6_requant(y[1], p.inv_sout));
        *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(p.out) + at + o) =
            (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      } else if (p.out_kind == K6_OUT_BF16) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(y[0]);
        v.y = __float2bfloat16_rn(y[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(p.out) + at + o) = v;
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at + o) =
            make_float2(y[0], y[1]);
      }
    }
  }
}

template <int NWG, int C>
static int launch_block(const K6Params& p, int smem, cudaStream_t s) {
  static bool allowed[WG_MAX_DEVICES] = {};
  const cudaError_t e =
      wg_allow_smem(block_int8_kernel<NWG, C>, K6_SMEM_LIMIT, allowed);
  if (e != cudaSuccess) return (int)e;
  constexpr int TH = NWG * 8;
  const dim3 grid((p.w + K6_TW - 1) / K6_TW, (p.h + TH - 1) / TH, p.batch);
  block_int8_kernel<NWG, C><<<grid, NWG * 128, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// C entry (ctypes). x: int8 NHWC (batch, h, w, c) contiguous, 16-byte
// aligned, c = 128 or 256, cmid a multiple of 16 in 16 .. 256. With cmid_p =
// cmid rounded up to 64: w1: (cmid_p, c) int8, row n the 1x1 weights of mid
// channel n (zero past cmid); w2: (c, ksteps * 128) int8, ksteps =
// ceil(9 * cmid_p / 128), row o holding output channel o's 3x3 weights at
// K = tap * cmid_p + mid channel (zero past cmid and past 9 * cmid_p).
// deq1/b1: (cmid,) float32, deq2/b2: (c,) float32. out: (batch, h, w, c)
// contiguous, int8 (out_kind 0), bf16 (1) or float32 (2). tile_h: the
// caller's tile plan, 8 or 16 output rows a block. Launch on `stream`,
// allocate nothing, return cudaGetLastError().
extern "C" int yolo_residual_block_int8(
    const void* x, const void* w1, const void* w2, const float* deq1,
    const float* b1, const float* deq2, const float* b2, int batch, int h,
    int w, int c, int cmid, float inv_smid, float inv_smid2, float smid2,
    float s_in, float inv_sout, int out_kind, void* out, int tile_h,
    void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 ||
      (c != 128 && c != 256) || cmid < 16 || cmid > 256 || cmid % 16 ||
      (tile_h != 8 && tile_h != 16) || (h + tile_h - 1) / tile_h > 65535 ||
      out_kind < K6_OUT_INT8 || out_kind > K6_OUT_F32)
    return (int)cudaErrorInvalidValue;
  const int cmid_p = k6_cmid_padded(cmid);
  const int smem = k6_smem_bytes(tile_h, c, cmid_p);
  if (smem > K6_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  K6Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.deq1 = deq1;
  p.b1 = b1;
  p.deq2 = deq2;
  p.b2 = b2;
  p.out = out;
  p.batch = batch;
  p.h = h;
  p.w = w;
  p.cmid = cmid;
  p.cmid_p = cmid_p;
  p.ksteps = k6_ksteps(cmid_p);
  p.out_kind = out_kind;
  p.inv_smid = inv_smid;
  p.inv_smid2 = inv_smid2;
  p.smid2 = smid2;
  p.s_in = s_in;
  p.inv_sout = inv_sout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_h == 8)
    return c == 128 ? launch_block<1, 128>(p, smem, s)
                    : launch_block<1, 256>(p, smem, s);
  return c == 128 ? launch_block<2, 128>(p, smem, s)
                  : launch_block<2, 256>(p, smem, s);
}
