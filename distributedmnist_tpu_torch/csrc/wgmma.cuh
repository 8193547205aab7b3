// Hopper (sm_90a) warpgroup matrix-multiply building blocks shared by the
// tensor-core attention kernels (csrc/flash_attention_fwd.cu,
// csrc/flash_attention_bwd.cu): the shared-memory tile layout and the
// cp.async loader that fills it, the wgmma matrix descriptor, the
// fence / commit / wait trio, the three product forms (SS with both
// operands K-major, RS, SS with B MN-major) and the accumulator
// fragment's row and column map.
//
// Tile layout. A tile is R rows of bf16, at most 256 columns, stored as
// column chunks of 64 (128 bytes a row): chunk c holds columns
// [64c, 64c + 64) of every row, R rows of 128 bytes, at byte c * R * 128.
// Within a chunk the 16-byte groups of row r are XOR-swizzled by r % 8
// (the 128-byte swizzle, Swizzle<3,4,3>), so each 8-row block is one
// 1024-byte swizzle atom and the tile base is 1024-byte aligned. A
// head_dim of 32 uses the first half of one chunk. The same tile serves
// as either wgmma operand:
//   * K-major (rows are M or N, columns are the reduction dim K):
//     q / k tiles in q.k^T, k / v / q / do tiles in the K3 score
//     products. One k16 step is 32 bytes inside a row's chunk.
//   * MN-major B (rows are K, columns are N): v in p.v, k in ds.k, do
//     and q in p^T.do and ds^T.q. One k16 step is 16 rows (2048 bytes);
//     N walks the column chunks at the leading-byte offset R * 128.
//
// Accumulator fragment of an m64nN product (f32, N/2 registers a
// thread): register i of thread t holds row 16 (t/32 % 4) + (t%32)/4 +
// 8 ((i/2) % 2) and column 8 (i/4) + 2 (t%4) + i%2. Registers
// [8kk, 8kk + 8) of a score fragment, packed in pairs to bf16x2, are
// exactly the A fragment of the k16 step kk of the next product (the
// register-sourced "RS" form), so p and ds never go through shared
// memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmt_wgmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, col) in a swizzled tile of R rows.
__device__ __forceinline__ uint32_t tile_offset(int r, int col, int R) {
  return (col >> 6) * R * 128 + r * 128 +
         ((((col >> 3) & 7) ^ (r & 7)) << 4) + (col & 7) * 2;
}

template <int D>
__host__ __device__ constexpr int padded_cols() {  // columns a tile of head_dim D allocates
  return D < 64 ? 64 : D;
}

template <int R, int D>
__host__ __device__ constexpr int tile_bytes() {
  return R * padded_cols<D>() * 2;
}

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's completed shared-memory writes (cp.async lands
// through the generic proxy) visible to wgmma's operand reads (the
// async proxy). Call after cp_async_wait and before the barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + R) of a [s, D] bf16 matrix (element row stride
// `ld`, unit column stride, 16-byte aligned rows) into a swizzled tile;
// rows at or past s are zero-filled and never read from memory. Every
// one of the block's THREADS threads calls it.
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src,
                                          int64_t ld, int row0, int s) {
  constexpr int kGroups = D / 8;  // 16-byte groups a row
  for (int i = threadIdx.x; i < R * kGroups; i += THREADS) {
    const int r = i / kGroups, col = (i % kGroups) * 8;
    const bool ok = row0 + r < s;
    const __nv_bfloat16* g = src + (ok ? row0 + r : 0) * ld + col;
    cp_async16(tile + tile_offset(r, col, R), g, ok);
  }
}

// ------------------------------------------------------------ descriptors
// 64-bit shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading-dimension byte offset and stride-dimension byte
// offset, each >> 4; layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: the 8n rows from row0 of a tile of R rows, k16 step
// kk (columns [16kk, 16kk + 16)). SBO: 8 rows = 1024 bytes; LBO unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int R,
                                                 int row0, int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major B operand: tile rows [16kk, 16kk + 16) are K, every column
// chunk is N. LBO: one column chunk (R * 128 bytes); SBO: 8 rows.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int R,
                                                  int kk) {
  return make_desc(tile + kk * 2048, R * 128, 1024);
}

// ---------------------------------------------------------- synchronisation
// Before the first wgmma of a batch whose accumulator or A registers
// were written by ordinary instructions.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin the registers of an in-flight accumulator to this point in the
// program, so the compiler neither reads them before wait() nor moves
// their initialisation past the issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------------------- fragment helpers
// Row (0..63, within the warpgroup's 64) and column of register i.
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of an m64nN score fragment (N keys), rounded to bf16:
// a[kk] feeds k16 step kk.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// ------------------------------------------------------------- products
// d (m64 x N, f32) = (scale_d ? d : 0) + A.B^T for one k16 step, both
// operands K-major in shared memory ("SS").
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d);
// d += A.B for one k16 step, A (m64 x k16 bf16) in registers, B MN-major
// in shared memory ("RS").
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int scale_d);
// d += A.B for one k16 step, A K-major and B MN-major, both in shared
// memory: the RS product's B with an A tile the kernel stored itself
// (e.g. the transpose of a score fragment).
template <int N>
__device__ __forceinline__ void mma_ss_mn(float (&d)[N / 2], uint64_t a,
                                          uint64_t b, int scale_d);

#define DMT_D8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DMT_D32(d) DMT_D8(d, 0), DMT_D8(d, 8), DMT_D8(d, 16), DMT_D8(d, 24)
#define DMT_D64(d) DMT_D32(d), DMT_D8(d, 32), DMT_D8(d, 40), DMT_D8(d, 48), \
                   DMT_D8(d, 56)
#define DMT_D128(d)                                                       \
  DMT_D64(d), DMT_D8(d, 64), DMT_D8(d, 72), DMT_D8(d, 80), DMT_D8(d, 88), \
      DMT_D8(d, 96), DMT_D8(d, 104), DMT_D8(d, 112), DMT_D8(d, 120)

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DMT_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DMT_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DMT_D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : DMT_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss_mn<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : DMT_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss_mn<128>(float (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : DMT_D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<256>(float (&d)[128], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : DMT_D128(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : DMT_D128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


// ------------------------------------------------------------- host side
// Launch `kernel` on `grid` x `threads` with `smem` bytes of dynamic
// shared memory; or, when info is not null, only say what that launch
// would get, for the libraries' *_occupancy queries: info[0..2] = blocks
// resident per SM, threads a block, dynamic shared memory bytes
// (registers and spills are ptxas's to report). Returns a CUDA error
// code (cudaGetLastError() after a launch).
template <typename Kernel, typename... Args>
int run(Kernel kernel, dim3 grid, int threads, size_t smem,
        cudaStream_t stream, int* info, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info == nullptr) {
    kernel<<<grid, threads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], kernel, threads, smem));
}

// 16-byte cp.async and vector loads need 16-byte aligned rows: every
// base pointer and every (batch, seq, head) element stride a multiple
// of 8 bf16 elements.
inline bool aligned16(const void* const* ptrs, int n_ptrs,
                      const int64_t* strides, int n_strides) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

#undef DMT_D8
#undef DMT_D32
#undef DMT_D64
#undef DMT_D128

}  // namespace dmt_wgmma
