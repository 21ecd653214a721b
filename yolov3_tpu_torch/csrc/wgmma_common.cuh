// Building blocks of the port's kernels on Hopper's warpgroup matrix
// multiply (wgmma), CUDA C++ for sm_90a: the launchers' opt-in to more than
// 48 KB of dynamic shared memory, the asynchronous 16-byte copies into
// shared memory, the 128-byte swizzle and the shared-memory matrix
// descriptors of K-major tiles (swizzled, and without swizzle) and of
// MN-major swizzled tiles, the wgmma fences, commits and waits, the bf16
// m64nNk16 products with float32 sums for N = 8, 32, 64, 96 and 128 (either
// operand K-major or, by the transpose flag, MN-major) with their float32
// promotion, the int8 m64nNk32 products with int32 sums for N = 64, 128
// and 256, and the TF32 m64nNk8 products (A in registers) for N = 32, 64,
// 96 and 128 with the split of float32 operands into two TF32 parts and the
// 3xTF32 K loop that K5's and K4's float32 kernels share. Included by
// conv3x3_mma.cuh (K5), decode_fused.cu (K4), block_int8.cu (K6) and
// probe.cu (T1's wgmma cores, T2); decode_packed.cu
// (K1, K1c), decode_full.cu (K3) and nms_suppress.cu (K2) take the opt-in
// and the asynchronous copies.
//
// Tile layout: an operand tile is a run of 128-byte rows (64 bf16 or 128
// int8 channels of one pixel, or of one weight row), K-major, laid out with
// the 128-byte swizzle that the descriptors name: 16-byte chunk j of row r
// sits at chunk j ^ (r & 7). A tile starts on a 1,024-byte boundary (eight
// rows: one period of the swizzle). A product reads 32 bytes of every row
// (16 bf16 channels, or 32 int8 channels); the k-th product of a tile
// starts 32 * k bytes in, which is +2 in the descriptor's address field,
// for either type.
//
// int8 products take both operands K-major (wgmma has no transpose for
// them), so a B operand is stored [N][K], K contiguous. A bf16 operand may
// stay MN-major, as a row-major (K, N) matrix lies: its tile is 128-byte
// rows of 64 N elements, one row per k, in the same swizzle.
//
// float32 sums: the tensor cores add the products of one K step in float32
// but truncate when they align the addends, and over K in the thousands
// that error passes a float32 bar on outputs near zero. So each K step is
// summed there from zero and the steps are added on the CUDA cores, rounded
// to nearest (wg_promote). int32 sums are exact and need no promotion: the
// largest an int8 product of K = 9 * 256 reaches is 127 * 127 * 2,304, about
// 3.7e7, far below 2^31.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WG_ROW 128  // bytes of one operand tile row: 64 bf16 / 128 int8
#define WG_HALF 64  // bf16 channels of one operand tile

#define WG_MAX_DEVICES 64

// Allow `kernel` `bytes` of dynamic shared memory (above the 48 KB a kernel
// gets without asking) once per device; `allowed` is the caller's flag per
// device for this kernel, so that a capture into a CUDA graph after the
// first call makes no such request (a repeat by a racing thread is
// harmless).
template <typename Kernel>
static inline cudaError_t wg_allow_smem(Kernel kernel, int bytes,
                                        bool (&allowed)[WG_MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < WG_MAX_DEVICES && allowed[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < WG_MAX_DEVICES) allowed[dev] = true;
  return e;
}

__device__ __forceinline__ uint32_t wg_smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes = 0 reads nothing and writes zeros
// (src must still be a valid address)
__device__ __forceinline__ void wg_cp_async16(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// the same through L1, for rows the block reads again soon
__device__ __forceinline__ void wg_cp_async16_l1(uint32_t dst,
                                                 const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void wg_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to the asynchronous
// proxy, through which wgmma reads its operands
__device__ __forceinline__ void wg_fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major bf16 tile with 128-byte rows
// and the 128-byte swizzle: start address / 16 in bits 0-13, leading byte
// offset (unused for a swizzled K-major tile) 1 in bits 16-29, stride byte
// offset = 8 rows * 128 B = 1,024 B / 16 in bits 32-45, layout type 1
// (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// wgmma shared-memory descriptor of a K-major tile WITHOUT swizzle (layout
// type 0): the tile is made of core matrices of 8 rows x 16 bytes, each 128
// contiguous bytes (row i of a core matrix at +16 * i). A product's 32 bytes
// of K are two core matrices side by side, `lbo` bytes apart (leading byte
// offset); the next 8 rows start `sbo` bytes further (stride byte offset).
// The start address needs only 16-byte alignment, so a tile can begin at
// any row of a larger array: K6's 3x3 reads each tap's rows this way.
__device__ __forceinline__ uint64_t wg_desc_plain(uint32_t saddr, uint32_t lbo,
                                                  uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

// wgmma shared-memory descriptor of an MN-major ("transposed") 16-bit tile
// with the 128-byte swizzle, for the A or B operand of a bf16 product with
// its transpose flag set: a 128-byte row holds 64 consecutive M (or N)
// elements of one k, eight rows of consecutive k make a 1,024-byte swizzle
// atom (chunk j of row r at j ^ r, as for K-major tiles). `lbo` is the byte
// stride between atoms along M / N (64 elements apart), `sbo` between atoms
// along K (8 k apart); layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void wg_fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the float32 promotion: one K step's sums (acc) added to the running sums
// on the CUDA cores
template <int R>
__device__ __forceinline__ void wg_promote(float (&sum)[R],
                                           const float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) sum[i] += acc[i];
}

// d (64 x N, float32, this warpgroup's fragment: N / 2 values a thread) =
// A (64 x 16, bf16 in shared memory) * B (N x 16, bf16 in shared memory) +
// (scale_d ? d : 0). Both operands are K-major unless TA / TB is 1: then
// that operand is MN-major (wg_desc_mn), the transpose wgmma offers for
// 16-bit types only. Fragment layout: thread (warp, lane) of the warpgroup
// holds rows warp * 16 + lane / 4 (+ 8), columns nb * 8 + (lane % 4) * 2
// (+ 1) in d[nb * 4 + hr * 2 + e].
template <int N, int TA = 0, int TB = 0>
struct WgmmaM64K16;

template <int TA, int TB>
struct WgmmaM64K16<8, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, %8;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaM64K16<32, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaM64K16<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaM64K16<96, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, %51, %52;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct WgmmaM64K16<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wg_mma_m64k16(float (&d)[N / 2],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  WgmmaM64K16<N, TA, TB>::run(d, desc_a, desc_b, scale_d);
}

// d (64 x N, int32, this warpgroup's fragment: N / 2 values a thread, in the
// layout of the bf16 form above) = A (64 x 32, int8, K-major in shared
// memory) * B (N x 32, int8, K-major in shared memory) + (scale_d ? d : 0).
// The sums are exact.
template <int N>
struct WgmmaM64K32S8;

template <>
struct WgmmaM64K32S8<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaM64K32S8<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaM64K32S8<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
        "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};


template <int N>
__device__ __forceinline__ void wg_mma_m64k32_s8(int (&d)[N / 2],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  WgmmaM64K32S8<N>::run(d, desc_a, desc_b, scale_d);
}


// ---------------------------------------------------------------- TF32
//
// float32 operands on the tensor cores as split TF32 ("3xTF32"): each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), where tf32()
// rounds to the 10 mantissa bits TF32 keeps (to nearest, ties away from
// zero: cvt.rna, which is (bits + 0x1000) & ~0x1fff) and x - hi is exact.
// a * b is then hi_a * hi_b + hi_a * lo_b + lo_a * hi_b, three TF32
// products whose sum misses a * b by at most about 2^-21 |a b| (lo_a *
// lo_b, under 2^-22, and the rounding of the two lo parts): float32
// accuracy at the TF32 rate, 495 TFLOP/s dense on an H100, 165 TFLOP/s of
// float32 work against the CUDA cores' 67. The plain split is
// ops/tf32.py :: split_tf32 (hi, and lo before its rounding to TF32).
//
// Layout: TF32 products take both operands K-major (wgmma's transpose flag
// exists only for 16-bit types). A 128-byte tile row holds 32 float32
// values (WG_F32) in the same 128-byte swizzle as the bf16 tiles; a
// product (k = 8) reads 32 bytes of every row, so the k-th product of a
// tile starts +2 in the descriptor's address field, as for bf16. The A
// operand (activations) comes from registers (the fragment below), split
// there; B (weights) is a pair of shared-memory tiles, hi and lo, copied
// from the two halves the wrapper splits once per weight tensor
// (ops/tf32.py :: tf32_operands): splitting B in the kernel would cost a
// pass over the tile in shared memory every K step, where the products'
// operand reads already leave little bandwidth.

#define WG_F32 32  // float32 values of one operand tile row (128 bytes)

// x rounded to TF32, as a float32 bit pattern with the low 13 bits zero
__device__ __forceinline__ uint32_t wg_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void wg_split_tf32(float x, uint32_t& hi,
                                              uint32_t& lo) {
  hi = wg_tf32(x);
  lo = wg_tf32(x - __uint_as_float(hi));
}

// d (64 x N, float32, the fragment layout of the bf16 products) = A (64 x 8,
// TF32 in registers) * B (N x 8, TF32, K-major in shared memory) + (scale_d
// ? d : 0). A's fragment, thread (warp, lane) of the warpgroup, g = lane /
// 4, t = lane % 4: a[0] = A[warp * 16 + g][t], a[1] = A[warp * 16 + g +
// 8][t], a[2] = A[warp * 16 + g][t + 4], a[3] = A[warp * 16 + g + 8][t + 4].
template <int N>
struct WgmmaM64K8TF32;

template <>
struct WgmmaM64K8TF32<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaM64K8TF32<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaM64K8TF32<96> {
  static __device__ __forceinline__ void run(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaM64K8TF32<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <int N>
__device__ __forceinline__ void wg_mma_m64k8_tf32(float (&d)[N / 2],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  WgmmaM64K8TF32<N>::run(d, a, desc_b, scale_d);
}

// The K loop of a float32 GEMM tile on the tensor cores, 3xTF32, shared by
// K5's and K4's float32 kernels. The block's ring holds STAGES K steps of
// 32 channels, each [A: BM rows][B hi: NP rows][B lo: NP rows] of 128-byte
// swizzled rows, every tile on a 1,024-byte boundary. `load_next(stage)`
// copies the next step's A rows, B hi rows and B lo rows into that stage
// (A at +0, B hi at +BM * 128, B lo at +(BM + NP) * 128) as ONE cp.async
// group, an empty group past the last step. The warpgroup (wm, wn)
// multiplies A rows wm * 64 .. + 63 by B rows wn * N .. + N - 1 into `sum`
// (its N / 2 fragment values, zeroed here).
//
// Step s: its A fragment is read from shared memory and split in
// registers; three products a K slice of 8, the small ones first (lo * hi,
// hi * lo, then hi * hi), summed by the tensor cores from zero over the
// step's 32 channels and added to `sum` on the CUDA cores (wg_promote: the
// tensor cores truncate when they align the addends). While they run, the
// block copies step s + STAGES - 1 into the stage step s - 1 left.
template <int BM, int NP, int N, int STAGES, typename Load>
__device__ __forceinline__ void wg_gemm_tf32x3(float (&sum)[N / 2], int steps,
                                               uint32_t ring,
                                               unsigned char* ring_ptr,
                                               int wm, int wn,
                                               Load& load_next) {
  constexpr uint32_t A_BYTES = BM * WG_ROW;
  constexpr uint32_t B_BYTES = NP * WG_ROW;
  constexpr uint32_t STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static_assert(STAGES >= 2, "one step multiplied, one in flight");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // this thread's A rows (row & 7 == g: the swizzle term) and float t
  const uint32_t a_row = (uint32_t)(wm * 64 + warp * 16 + g) * WG_ROW + 4 * t;

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = sum[i] = 0.0f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) load_next(p);

  int st = 0;  // the stage of step s
  for (int s = 0; s < steps; ++s) {
    // step s has landed: this thread's copies, then everyone's; the
    // barrier also says every warpgroup is done with step s - 1's products
    wg_cp_async_wait<STAGES - 2>();
    wg_fence_async_proxy();
    __syncthreads();
    const uint32_t stage = ring + st * STAGE_BYTES;
    const unsigned char* a_tile = ring_ptr + st * STAGE_BYTES;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // a[q]: row + 8 * (q & 1), float t + 4 * (q >> 1) of slice kk,
        // which lies in 16-byte chunk 2 * kk + (q >> 1) of its row
        const uint32_t chunk = (uint32_t)(2 * kk + (q >> 1)) ^ (uint32_t)g;
        const float v = *reinterpret_cast<const float*>(
            a_tile + a_row + (q & 1) * 8 * WG_ROW + (chunk << 4));
        wg_split_tf32(v, ahi[kk][q], alo[kk][q]);
      }
    const uint64_t dhi = wg_desc(stage + A_BYTES + wn * N * WG_ROW);
    const uint64_t dlo = wg_desc(stage + A_BYTES + B_BYTES + wn * N * WG_ROW);
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_mma_m64k8_tf32<N>(acc, alo[kk], dhi + 2 * kk, kk > 0);
      wg_mma_m64k8_tf32<N>(acc, ahi[kk], dlo + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_mma_m64k8_tf32<N>(acc, ahi[kk], dhi + 2 * kk, 1);
    wg_commit();
    // while the products run: step s + STAGES - 1 into the stage step s - 1
    // has left
    load_next(st == 0 ? STAGES - 1 : st - 1);
    wg_wait<0>();
    wg_fence_acc(acc);
    wg_promote(sum, acc);
    st = st + 1 == STAGES ? 0 : st + 1;
  }
  // every product is done; the copy groups still open are empty
  wg_cp_async_wait<0>();
  __syncthreads();
}
