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
// What bounds it on the H100: the greedy chain, one dependent step per kept
// candidate, not bytes (K * 24 bytes per image) and not the K^2 / 2 IoUs,
// which the whole card does in a few microseconds. Two launches:
//
// Phase 1, nms_bits_kernel: the conflict bits over the card. A block takes
// (image, 64-row tile, 64-column tile) of the UPPER triangle only, the
// column tiles at or right of the row tile: T (T + 1) / 2 blocks an image
// for T = ceil(K / 64), so 36 an image at K = 512 (288 at B = 8). Its 128
// threads each test one row against 32 columns, both tiles' boxes held in
// shared memory, and write one 32-bit word of the scratch the wrapper
// allocates:
//
//   bits[b][i][w], w < k2_row_words(K) = ceil(K / 32) rounded up to a
//   multiple of 4 (rows of 16-byte pieces), holds conflict(i, 32 w + t) in
//   bit t for every word of the row's tiles, 2 floor(i / 64) <= w <
//   2 ceil(K / 64), 0 for columns >= K; the words left of the row's
//   diagonal tile (and any padding past 2 ceil(K / 64)) are not written.
//
// The plain version of this layout is yolov3_tpu_torch/ops/cuda_nms.py ::
// conflict_bits_reference (unwritten words 0 there). The test is symmetric
// bit for bit (max, min and the area sum commute), so row j's bits for
// columns i > j are the conflicts the walk needs.
//
// Phase 2, nms_walk_kernel: the greedy walk, one block an image. The block
// copies the image's K rows of bits into shared memory with 16-byte
// cp.async (128 KB at K = 1024) and packs the valid mask into 32-bit words
// with ballots while the copy runs. Then one warp walks: lane l holds word l
// of the ALIVE mask (valid and not yet removed). The next non-zero word
// (a ballot, __ffs, one shuffle) is walked in every lane's registers: its
// lowest bit i is kept (__ffs), row i's own word clears the bits i
// suppresses there (one broadcast read from shared memory), and every lane
// right of it ANDs out word l of row i. So the walk takes one step per KEPT
// candidate, plus one ballot per word that holds one: removed and invalid
// slots cost nothing, and an invalid tail ends it. Last, every thread
// writes the keep bytes from the kept words: every slot is written.
//
// Float contract: built with -fmad=false and without fast math: the union
// (area_i + area_j) - inter must not contract into an FMA, or keep masks
// stop matching the plain PyTorch version
// (yolov3_tpu_torch/ops/cuda_nms.py :: suppress_reference) bit for bit.
//
// Ablation macros (yolov3_tpu_torch/tools/ablate_phases.py): -DK2_SKIP_PHASE1
// launches the walk alone, -DK2_SKIP_PHASE2 the conflict bits alone.

#include "wgmma_common.cuh"

#define K2_MAX_K 1024
#define K2_TILE 64            // phase 1: 64 rows x 64 columns (two words)
#define K2_BITS_THREADS 128   // phase 1: one word a thread (2 * K2_TILE)
#define K2_WALK_THREADS 256   // phase 2: all copy, one warp walks

__host__ __device__ inline int k2_row_words(int k) {
  return (((k + 31) >> 5) + 3) & ~3;
}

// max / min that return NaN when either input is NaN, like torch.maximum,
// torch.minimum and torch.clamp in the plain version (fmaxf / fminf would
// drop the NaN)
__device__ __forceinline__ float k2_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float k2_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float k2_area(float4 b) {
  return k2_max(b.z - b.x, 0.0f) * k2_max(b.w - b.y, 0.0f);
}

// conflict(i, j): the IoU test and the class test, in the float order of
// the plain version (ops/nms.py :: iou_matrix); NaN corners give a NaN IoU,
// never a conflict, and an inf - inf union stays NaN
__device__ __forceinline__ bool k2_conflict(float4 bi, float ai, int ci,
                                            float4 bj, float aj, int cj,
                                            float iou_thresh) {
  const float iw = k2_max(k2_min(bi.z, bj.z) - k2_max(bi.x, bj.x), 0.0f);
  const float ih = k2_max(k2_min(bi.w, bj.w) - k2_max(bi.y, bj.y), 0.0f);
  const float inter = iw * ih;
  const float den = k2_max((ai + aj) - inter, 1e-9f);
  // a zero numerator skips the divide's slow path: 0 / den is +-0, or NaN
  // for a NaN den, so the test is 0 > iou_thresh where den is a number
  const bool over = inter == 0.0f ? den == den && 0.0f > iou_thresh
                                  : inter / den > iou_thresh;
  return over && ci == cj;
}

// Phase 1. Grid: (batch, tiles of the upper triangle), row-major: tile t of
// an image is (ti, tj) with tj >= ti. Thread pairs share a row: thread
// (row r, word w) tests row ti * 64 + r against the 32 columns of word w of
// the tile and writes that word, so a warp writes 16 rows x 8 contiguous
// bytes. (Four threads a word, 8 tests each, measured slower: PERF.md.)
__global__ void __launch_bounds__(K2_BITS_THREADS)
nms_bits_kernel(const float4* __restrict__ boxes,
                const int* __restrict__ classes, int k, float iou_thresh,
                unsigned* __restrict__ bits) {
  __shared__ float4 tile_box[2][K2_TILE];  // [0]: the rows, [1]: the columns
  __shared__ float tile_area[2][K2_TILE];
  __shared__ int tile_cls[2][K2_TILE];
  const int tiles = (k + K2_TILE - 1) / K2_TILE;
  int ti = 0, t = blockIdx.y;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const long long base = (long long)blockIdx.x * k;
  const int tid = threadIdx.x;
  {
    const int side = tid / K2_TILE, s = tid % K2_TILE;
    const int j = (side ? tj : ti) * K2_TILE + s;
    if (j < k) {
      const float4 bj = boxes[base + j];
      tile_box[side][s] = bj;
      tile_area[side][s] = k2_area(bj);
      tile_cls[side][s] = classes[base + j];
    }
  }
  __syncthreads();
  const int w = tid & 1, r = tid >> 1;
  const int i = ti * K2_TILE + r;
  if (i >= k) return;
  const int jn = min(32, k - (tj * K2_TILE + w * 32));  // <= 0: past K
  const float4 bi = tile_box[0][r];
  const float ai = tile_area[0][r];
  const int ci = tile_cls[0][r];
  unsigned word = 0u;
  for (int c = 0; c < jn; ++c)
    if (k2_conflict(bi, ai, ci, tile_box[1][w * 32 + c],
                    tile_area[1][w * 32 + c], tile_cls[1][w * 32 + c],
                    iou_thresh))
      word |= 1u << c;
  bits[(base + i) * k2_row_words(k) + 2 * tj + w] = word;
}

// Phase 2. Grid: batch; dynamic shared memory: K * k2_row_words(K) words.
__global__ void __launch_bounds__(K2_WALK_THREADS)
nms_walk_kernel(const unsigned* __restrict__ bits,
                const unsigned char* __restrict__ valid, int k,
                unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned rows[];
  __shared__ unsigned valid_words[32], kept_words[32];
  const int rw = k2_row_words(k), words = (k + 31) >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * k;
  const unsigned* src = bits + base * rw;
  const uint32_t dst = wg_smem_u32(rows);
  for (int q = tid; q < k * rw / 4; q += K2_WALK_THREADS)
    wg_cp_async16(dst + 16 * q, src + 4 * q, 16);
  wg_cp_async_commit();
  // the valid mask as words, one ballot a word, while the copy runs
  for (int w = warp; w < words; w += K2_WALK_THREADS / 32) {
    const int i = w * 32 + lane;
    const unsigned v = __ballot_sync(0xffffffffu, i < k && valid[base + i]);
    if (lane == 0) valid_words[w] = v;
  }
  wg_cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    // lane l: word l of the alive mask; cur: the word being walked, held
    // by every lane, so a step needs no shuffle: the lowest bit of cur is
    // kept, every lane reads that row's word wl (one broadcast) to update
    // cur and its own word l > wl off the chain
    unsigned alive = lane < words ? valid_words[lane] : 0u, mine = 0u;
    int wl = -1;
    for (;;) {
      const unsigned nz = __ballot_sync(0xffffffffu, alive != 0u && lane > wl);
      if (nz == 0u) break;
      wl = __ffs(nz) - 1;
      unsigned cur = __shfl_sync(0xffffffffu, alive, wl);
      while (cur != 0u) {
        const int bit = __ffs(cur) - 1;  // the lowest alive candidate: kept
        const unsigned* row = rows + (wl * 32 + bit) * rw;
        cur &= ~(row[wl] | (1u << bit));
        if (lane > wl && lane < words) alive &= ~row[lane];
        if (lane == wl) mine |= 1u << bit;
      }
    }
    kept_words[lane] = mine;
  }
  __syncthreads();
  for (int i = tid; i < k; i += K2_WALK_THREADS)
    keep[base + i] = (kept_words[i >> 5] >> (i & 31)) & 1u;
}

// C entry (ctypes). boxes: device float32 (batch, k, 4) contiguous; classes:
// int32 (batch, k); valid and keep: bool / uint8 (batch, k); bits: the
// phase 1 scratch, (batch, k, k2_row_words(k)) 32-bit words, 16-byte
// aligned. Launches phase 1 then phase 2 on `stream`, allocates nothing,
// returns the CUDA error code (0 on success).
extern "C" int yolo_nms_suppress(const float* boxes, const int* classes,
                                 const unsigned char* valid, int batch, int k,
                                 float iou_thresh, unsigned* bits,
                                 unsigned char* keep, void* stream) {
  if (batch < 1 || k < 1 || k > K2_MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  static bool allowed[WG_MAX_DEVICES];
  cudaError_t e = wg_allow_smem(
      nms_walk_kernel, K2_MAX_K * k2_row_words(K2_MAX_K) * 4, allowed);
  if (e != cudaSuccess) return (int)e;
#ifndef K2_SKIP_PHASE1
  const int tiles = (k + K2_TILE - 1) / K2_TILE;
  nms_bits_kernel<<<dim3(batch, tiles * (tiles + 1) / 2), K2_BITS_THREADS, 0,
                    s>>>(reinterpret_cast<const float4*>(boxes), classes, k,
                         iou_thresh, bits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#endif
#ifndef K2_SKIP_PHASE2
  nms_walk_kernel<<<batch, K2_WALK_THREADS,
                    (size_t)k * k2_row_words(k) * 4, s>>>(bits, valid, k,
                                                          keep);
#endif
  return (int)cudaGetLastError();
}
