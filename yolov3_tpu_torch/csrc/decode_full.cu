// K3 (full decode), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel yolov3_tpu/ops/pallas_decode.py ::
// decode_head_pallas (body _decode_kernel): each head map
// (B, gy, gx, A * (5 + C)) becomes its rows of the reference Darknet.forward
// tensor (B, N, 5 + C), cell-major within a head (row head_offset +
// cell * A + anchor), heads concatenated in cfg order:
//
//   x, y : (sig(t) + cell column / row) * stride
//   w, h : exp(min(t, 60)) * anchor width / height
//   objectness and classes : sig(t)
//
// The sigmoid is decode_common.cuh's (1 / (1 + expf(-t))), the clamp
// k1_clamp60 and the exp expf, as in K1 / K1c / K4, so with -fmad=false the
// full decode equals its plain version (ops/decode.py :: decode_head on the
// float32 map) bit for bit.
//
// What bounds it on the H100: memory, by the bytes. yolov3 at 416, batch 8:
// 28.96 MB in at float32 (14.48 MB at bf16) and 28.96 MB out, 17.3 us (13.0
// us) at 3.35 TB/s. The design before this one took three launches and a
// torch.cat (which moves the whole output a second time), one thread an
// element with 64-bit divisions by runtime values to find it, and 4-byte
// loads and stores. This one:
//
// * One launch for all the heads of a call, writing straight into the
//   concatenated output. A head table travels by value in the parameter
//   block (K3Table; the block finds its head by static indices only); the
//   per-head entry (ops/cuda_decode.py :: decode_head) passes a one-row
//   table. The wrapper's planner (plan_full_decode) lays the blocks out.
// * For a dense map the flattened output of one (image, head) is the
//   flattened input of that (image, head), element for element. A block
//   owns K3_TILE consecutive elements of one such range: a 64-bit base once
//   per block, 32-bit offsets inside it (a range is below 2^31 elements;
//   the planner checks).
// * Both sides move in 16-byte pieces. Neither range is 16-byte aligned in
//   general (at 416 head 1 starts 507 * 85 * 4 = 172,380 bytes into an
//   image, and one image is 10,647 * 85 * 4 bytes, both 12 mod 16), so the
//   block copies the aligned 16-byte pieces that cover its input range into
//   shared memory (cp.async; the last piece cut by its source size), decodes
//   into a second shared buffer laid out as the output is aligned, and
//   stores that in 16-byte pieces, peeling the two edge pieces into single
//   floats. A map that is not dense (channel-padded, a channel-slice view,
//   an unaligned base: cuda_decode.dense_map) is staged element by element
//   from its strides instead: a strided path inside the same kernel.
// * No division per element. A thread takes elements tid, tid + 256, ... of
//   the tile; it finds (column, row, anchor, channel) of its first one by
//   multiply-shift with magic numbers the C entry makes for the head, and
//   then steps the four counters with carries (the step, 256 elements, is
//   split into them on the host too). Column and row are kept as floats,
//   the operands of the decode, so no element pays an int-to-float
//   conversion.
// * One exp and one divide an element, whatever the channel: e = expf of
//   -t, or of min(t, 60) on w and h; the sigmoid is 1 / (1 + e). No lane
//   of a warp waits on another lane's branch.
//
// The map is float32 or bf16 (a template on the load type, widened exactly
// to float before any math).
//
// Ablation macros (yolov3_tpu_torch/tools/ablate_phases.py): -DK3_SKIP_MATH
// writes the widened input (no decode), -DK3_SKIP_STORE decodes into shared
// memory and stores nothing.

#include "decode_common.cuh"
#include "wgmma_common.cuh"

#define K3_MAX_HEADS 8
#define K3_THREADS 256
#define K3_TILE 4096      // output elements a block: 16 a thread
#define K3_HEAD_ARGS 12   // long longs a head in the C entry

// n / d for 0 <= n < 2^31 as (n * m) >> s, with m and s made on the host by
// k3_magic: floor(n / d) exactly (Granlund and Montgomery: m = floor(2^(31
// + l) / d) + 1, s = 31 + l, l = ceil(log2 d), so d <= 2^l and m < 2^32)
struct K3Div {
  unsigned m;
  int s;
};

__device__ __forceinline__ int k3_div(int n, K3Div d) {
  return (int)(((unsigned long long)(unsigned)n * d.m) >> d.s);
}

struct K3Head {
  const void* feat;
  long long sb, sy, sx;  // element strides of image, row and column
  int gy, gx;
  int n_anchors, anchor0;  // anchors [anchor0, anchor0 + n_anchors) of the table
  int head_offset;         // the head's first output row of an image
  int first_block, tiles;  // its first block; blocks an image
  int dense;
  float stride;
  K3Div by_need, by_per, by_gx;  // A * (5 + C), 5 + C and gx
  // a block's step of K3_THREADS elements split into column, row, anchor
  // and channel (each below its bound, so one carry each)
  int step_x, step_y, step_a, step_k;
};

struct K3Table {
  K3Head head[K3_MAX_HEADS];
  AnchorSet anchors;
  int n_heads;
};

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
decode_full_kernel(const K3Table tab, int per, int n_total,
                   float* __restrict__ out) {
  __shared__ __align__(16) unsigned char k3_in[K3_TILE * sizeof(T) + 16];
  __shared__ __align__(16) float k3_out[K3_TILE + 4];
  __shared__ float k3_anchor[2 * K1_MAX_ANCHORS];
  // this block's head: the last whose first block is at or before it
  K3Head hd = tab.head[0];
#pragma unroll
  for (int i = 1; i < K3_MAX_HEADS; ++i)
    if (i < tab.n_heads && (int)blockIdx.x >= tab.head[i].first_block)
      hd = tab.head[i];
  const int tid = threadIdx.x;
  const int need = hd.n_anchors * per;  // elements of one cell
  const int seg = hd.gy * hd.gx * need;  // elements of one (image, head)
  const int bi = (int)blockIdx.x - hd.first_block;
  const int b = bi / hd.tiles;
  const int lo = (bi - b * hd.tiles) * K3_TILE;  // the tile: [lo, lo + len)
  const int len = min(K3_TILE, seg - lo);
  const T* feat = static_cast<const T*>(hd.feat) + b * hd.sb;
  const long long out0 =
      ((long long)b * n_total + hd.head_offset) * per + lo;
  if (tid < 2 * hd.n_anchors)
    k3_anchor[tid] = tab.anchors.wh[2 * hd.anchor0 + tid];

  // ---- the tile's input into k3_in; element lo sits at index `shift`
  int shift = 0;
  if (hd.dense) {
    const char* src = reinterpret_cast<const char*>(feat + lo);
    const int skew = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    shift = skew / (int)sizeof(T);
    // the first piece starts up to 15 bytes before the range, inside the
    // map (its base is 16-byte aligned); the last one is cut to the range
    const char* base = src - skew;
    const int bytes = skew + len * (int)sizeof(T);
    const uint32_t dst = wg_smem_u32(k3_in);
    for (int q = tid; 16 * q < bytes; q += K3_THREADS)
      wg_cp_async16(dst + 16 * q, base + 16 * q, min(16, bytes - 16 * q));
    wg_cp_async_commit();
    wg_cp_async_wait<0>();
  } else {
    // warps over the tile's cells, lanes over a cell's channels
    T* tile = reinterpret_cast<T*>(k3_in);
    const int lane = tid & 31;
    const int c_hi = (lo + len - 1) / need + 1;
    for (int c = lo / need + (tid >> 5); c < c_hi; c += K3_THREADS / 32) {
      const int y = c / hd.gx;
      const T* row = feat + y * hd.sy + (c - y * hd.gx) * hd.sx;
      const int i0 = c * need - lo;
      for (int ch = lane; ch < need; ch += 32)
        if (i0 + ch >= 0 && i0 + ch < len) tile[i0 + ch] = __ldg(row + ch);
    }
  }
  __syncthreads();

  // ---- decode into k3_out, element i at i + oshift: aligned as the output
  const int oshift = (int)(out0 & 3);
  const T* in = reinterpret_cast<const T*>(k3_in) + shift;
#ifdef K3_SKIP_MATH
  for (int i = tid; i < len; i += K3_THREADS)
    k3_out[i + oshift] = k1_widen(in[i]);
#else
  // the counters of element i = lo + tid: anchor a, channel k of the
  // anchor, and the cell's column x and row y as floats (small integers,
  // exact), the decode's operands; stepped by the head's split of
  // K3_THREADS elements
  int a, k;
  float x, y;
  {
    const int e = lo + tid, cell = k3_div(e, hd.by_need);
    const int ch = e - cell * need, row = k3_div(cell, hd.by_gx);
    a = k3_div(ch, hd.by_per);
    k = ch - a * per;
    y = (float)row;
    x = (float)(cell - row * hd.gx);
  }
  const float gx = (float)hd.gx, step_x = (float)hd.step_x;
  const float step_y = (float)hd.step_y;
#pragma unroll 2
  for (int i = tid; i < len; i += K3_THREADS) {
    // every value computed for every channel and the channel's chosen by
    // selects: no branch, so the unrolled loop interleaves two elements
    const float t = k1_widen(in[i]);
    const bool wh = (unsigned)(k - 2) < 2u;
    const float clamped = k1_clamp60(t);
    const float e = expf(wh ? clamped : -t);
    const float s = 1.0f / (1.0f + e);  // k1_sigmoid(t), bit for bit
    const float wa = e * k3_anchor[2 * a + (k & 1)];
    const float xy = (s + (k == 0 ? x : y)) * hd.stride;
    k3_out[i + oshift] = wh ? wa : (k < 2 ? xy : s);
    k += hd.step_k;
    bool carry = k >= per;
    k -= carry ? per : 0;
    a += hd.step_a + carry;
    carry = a >= hd.n_anchors;
    a -= carry ? hd.n_anchors : 0;
    x += carry ? step_x + 1.0f : step_x;
    carry = x >= gx;
    x -= carry ? gx : 0.0f;
    y += carry ? step_y + 1.0f : step_y;
  }
#endif
  __syncthreads();

  // ---- k3_out -> out in 16-byte pieces; the edge pieces float by float
  float* dst = out + (out0 - oshift);
  const int pieces = (oshift + len + 3) >> 2;
  for (int q = tid; q < pieces; q += K3_THREADS) {
    const int j0 = 4 * q - oshift;  // tile index of the piece's first float
#ifdef K3_SKIP_STORE
    if (per < 0)
#endif
    {
      if (j0 >= 0 && j0 + 4 <= len) {
        *reinterpret_cast<float4*>(dst + 4 * q) =
            *reinterpret_cast<const float4*>(k3_out + 4 * q);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j >= 0 && j0 + j < len) dst[4 * q + j] = k3_out[4 * q + j];
      }
    }
  }
}

static K3Div k3_magic(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  return K3Div{(unsigned)((1ull << (31 + l)) / d + 1), 31 + l};
}

// C entry (ctypes). head_args: per head K3_HEAD_ARGS long longs
//   [map pointer, sb, sy, sx, gy, gx, n_anchors, anchor0, head_offset,
//    first_block, tiles, dense]
// with the map a float32 (is_bf16 = 0) or bf16 (is_bf16 = 1) channels-last
// array addressed as feat[b * sb + y * sy + x * sx + channel]; dense = 1
// only where that is one packed range per image with a 16-byte aligned base
// (cuda_decode.dense_map). head_strides: per head its stride in pixels;
// anchors_wh: 2 * n_anchors_total floats (w0, h0, w1, h1, ...) of all heads
// in order. out: float32 (batch, n_total, 5 + n_classes), contiguous and
// 16-byte aligned; head h writes rows [head_offset, head_offset + gy * gx *
// n_anchors) of every image. blocks: the table's total (batch * tiles per
// head). Launch on `stream`, allocate nothing, return the CUDA error code
// (0 on success).
extern "C" int yolo_decode_full(const long long* head_args,
                                const float* head_strides, int n_heads,
                                const float* anchors_wh, int n_anchors_total,
                                int is_bf16, int blocks, int n_classes,
                                int n_total, float* out, void* stream) {
  if (n_heads < 1 || n_heads > K3_MAX_HEADS || n_anchors_total < 1 ||
      n_anchors_total > K1_MAX_ANCHORS || n_classes < 1 || blocks < 1 ||
      n_total < 1 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int per = 5 + n_classes;
  K3Table tab;
  tab.n_heads = n_heads;
  for (int h = 0; h < n_heads; ++h) {
    const long long* a = head_args + (long long)h * K3_HEAD_ARGS;
    K3Head& hd = tab.head[h];
    hd.feat = reinterpret_cast<const void*>(a[0]);
    hd.sb = a[1];
    hd.sy = a[2];
    hd.sx = a[3];
    hd.gy = (int)a[4];
    hd.gx = (int)a[5];
    hd.n_anchors = (int)a[6];
    hd.anchor0 = (int)a[7];
    hd.head_offset = (int)a[8];
    hd.first_block = (int)a[9];
    hd.tiles = (int)a[10];
    hd.dense = (int)a[11];
    hd.stride = head_strides[h];
    const int need = hd.n_anchors * per;
    hd.by_need = k3_magic(need);
    hd.by_per = k3_magic(per);
    hd.by_gx = k3_magic(hd.gx);
    const int sc = K3_THREADS / need, sr = K3_THREADS % need;
    hd.step_a = sr / per;
    hd.step_k = sr % per;
    hd.step_y = sc / hd.gx;
    hd.step_x = sc % hd.gx;
    const long long seg = a[4] * a[5] * a[6] * per;
    if (hd.gy < 1 || hd.gx < 1 || hd.n_anchors < 1 ||
        hd.anchor0 + hd.n_anchors > n_anchors_total || seg > 2147483647LL ||
        (seg + K3_TILE - 1) / K3_TILE != hd.tiles ||
        hd.head_offset + a[4] * a[5] * a[6] > n_total)
      return (int)cudaErrorInvalidValue;
  }
  for (int h = n_heads; h < K3_MAX_HEADS; ++h) tab.head[h] = tab.head[0];
  for (int i = 0; i < 2 * n_anchors_total; ++i)
    tab.anchors.wh[i] = anchors_wh[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    decode_full_kernel<bf16_bits><<<blocks, K3_THREADS, 0, s>>>(tab, per,
                                                                n_total, out);
  else
    decode_full_kernel<float><<<blocks, K3_THREADS, 0, s>>>(tab, per, n_total,
                                                            out);
  return (int)cudaGetLastError();
}
