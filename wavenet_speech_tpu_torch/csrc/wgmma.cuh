// Hopper tensor-core helpers shared by the bf16 fused block kernels
// (fused_block_bf16.cu, fused_block_bwd_bf16.cu): cp.async copies into
// 128-byte-swizzled shared-memory tiles, the wgmma shared-memory descriptors
// that read them, and bf16 x bf16 -> float32 wgmma.mma_async.
//
// Tile layout: a tile is a run of 128-byte rows (64 bf16 values each) whose
// base is 1024-byte aligned. Element (r, c), c < 64, lies at byte
//   r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2,
// the 128-byte swizzle that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and that
// a descriptor of layout type 1 (B128) reads.
//  * K-major operand (rows are M or N, the 64 values of a row are K): 8-row
//    groups 1024 bytes apart (SBO), a k16 step advances the start by 32 bytes.
//  * MN-major operand (rows are K, the 64 values of a row are M or N; the
//    wgmma transpose bit set): 8-row groups 1024 bytes apart (SBO), a k16 step
//    advances the start by 16 rows, 2048 bytes. Each such tile is one 64-wide
//    MN block, so a product takes M = 64 and N = 64 from it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TK = 64;             // reduction depth of one tile row: 64 bf16, 128 bytes
constexpr int ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// 16 bytes from global to shared memory; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (st.shared, finished cp.async)
// visible to wgmma, which reads through the async proxy; a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Loads `rows` tile rows: row r holds columns [c0, c0 + 64) of row row0 + r of
// a row-major matrix whose columns [0, split) are rows of s0 (length split)
// and [split, ncols) rows of s1 (length ncols - split). Zero where the row
// is outside [0, nrows) or the column is >= ncols. split and ncols are
// multiples of 8, the pointers 16-byte aligned. NT threads share the work.
template <int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, int rows, const bf16* s0, const bf16* s1,
                                          int split, int ncols, int row0, int nrows, int c0) {
  for (int id = threadIdx.x; id < rows * 8; id += NT) {
    const int r = id >> 3, c = c0 + (id & 7) * 8, row = row0 + r;
    const bool ok = row >= 0 && row < nrows && c < ncols;
    const bf16* p = s0;
    if (ok) p = c < split ? s0 + (size_t)row * split + c : s1 + (size_t)row * (ncols - split) + (c - split);
    cp16(dst + swz(r, (id & 7) * 8), p, ok);
  }
}

__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WST_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, 32 floats a thread) += A^T B, A (16 x 64) and B (16 x 64) both
// MN-major (the transpose bits set): the frame reduction's product
__device__ __forceinline__ void mma_n64_mn(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : WST_F8(0), WST_F8(8), WST_F8(16), WST_F8(24)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, 64 floats a thread) += A (64 x 16) B (16 x 128), both K-major
__device__ __forceinline__ void mma_n128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WST_F8(0), WST_F8(8), WST_F8(16), WST_F8(24), WST_F8(32), WST_F8(40), WST_F8(48),
        WST_F8(56)
      : "l"(a), "l"(b), "r"(1));
}
#undef WST_F8

// Where accumulator i of a thread of a warpgroup lies in its 64 x N tile:
// row 16 * warp + lane / 4 (+ 8 for odd i / 2), column 8 * (i / 4) +
// 2 * (lane % 4) (+ 1 for odd i).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float ld_shared_bf16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float ld_f(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// The dynamic shared memory, its start rounded up to 1024 bytes (the
// swizzle's period); a kernel asks for 1024 bytes more than it uses.
__device__ __forceinline__ uint32_t smem_base(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---- staging a warp's accumulator rows on their way to device memory ------
// A warp holds 16 rows of its warpgroup's 64 (frag_row(i) for accumulator
// i). They go into a 4096-byte tile of shared memory, 16 rows of 256 bytes
// whose 16-byte pieces are swizzled by row (no bank conflicts), and out as
// whole 16-byte pieces, two 256-byte rows a warp store, where the fragments
// alone would store 4 or 8 bytes a thread. The kernels stage in the ring
// slot of the step just consumed, after a barrier.
__device__ __forceinline__ uint8_t* smem_ptr(uint8_t* raw, uint32_t addr) {
  return raw + (addr - smem_u32(raw));
}
__device__ __forceinline__ int frag_row(int i) { return ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int stage_off(int r, int byte) {
  return r * 256 + ((((byte >> 4) ^ r) & 7) | ((byte >> 4) & 8)) * 16 + (byte & 15);
}
// Copies the warp's staging tile st to dst: row r to dst + r * ld bytes,
// rows below nrows, the first nbytes (a multiple of 16) of each.
__device__ __forceinline__ void stage_flush(const uint8_t* st, uint8_t* dst, size_t ld, int nrows,
                                            int nbytes) {
  __syncwarp();
  for (int k = threadIdx.x & 31; k < 256; k += 32) {
    const int r = k >> 4, c = (k & 15) * 16;
    if (r < nrows && c < nbytes)
      *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(st + stage_off(r, c));
  }
  __syncwarp();
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The main loop of every kernel here: S steps, each reading one slot of a
// ring of STAGES slots of SLOT bytes at `ring`. load(s, slot) fills step s's
// slot with cp.async; mma(s, slot) issues wgmma.fence, then its wgmma;
// when last(s) (the last step of an output tile) the products are waited for
// and epilogue(s) runs on the accumulators. With three or more slots a step's
// products run on while the next step's are issued and loads run STAGES - 2
// steps ahead; with two, loads run one step ahead and each step's products
// are waited for. A slot is refilled only after every warpgroup's products
// on it have completed (the barrier below).
template <int STAGES, int SLOT, class Load, class Mma, class Last, class Epi>
__device__ __forceinline__ void ring_loop(uint32_t ring, int S, Load load, Mma mma, Last last,
                                          Epi epilogue) {
  constexpr int WAIT = STAGES > 2 ? 1 : 0;  // product groups left running across a step
  constexpr int AHEAD = STAGES - 1 - WAIT;
  for (int s = 0; s < AHEAD; ++s) {
    if (s < S) load(s, ring + s * SLOT);
    cp_commit();
  }
  for (int s = 0; s < S; ++s) {
    cp_wait<AHEAD - 1>();  // step s's copies have landed
    fence_async_smem();
    __syncthreads();
    const int n = s + AHEAD;
    if (n < S) load(n, ring + (n % STAGES) * SLOT);
    cp_commit();
    mma(s, ring + (s % STAGES) * SLOT);
    wg_commit();
    if (last(s)) {
      wg_wait<0>();
      epilogue(s);
    } else {
      wg_wait<WAIT>();
    }
  }
  wg_wait<0>();
}

}  // namespace
