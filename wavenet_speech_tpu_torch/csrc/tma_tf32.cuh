// Hopper helpers shared by the float32 fused block kernels (fused_block.cu,
// fused_block_bwd.cu): float32-accurate products on the tensor cores as
// split TF32 wgmma, fed by TMA copies into a ring of mbarrier-guarded slots.
//
// The split. A float32 value v is carried as two TF32 values,
//   hi = tf32_rna(v),  lo = tf32_rna(v - hi)
// (round to nearest, ties away; v - hi is exact in float32, and lo is
// rounded explicitly because the tensor core would truncate it). A product
// a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi, three TF32 wgmma with
// float32 accumulators (mma_step): a product of two TF32 values is exact in
// float32, and hi + lo carries v to 2^-22 of it, so the dropped a_lo b_lo
// and the parts' rounding leave each product within a few units of
// float32's rounding (2^-24) of a b.
//
// TF32 wgmma reads its shared-memory operands only K-major (the transpose
// bits exist for 16-bit types). So A comes from registers: a thread loads
// its fragment of a float32 tile that TMA (or the kernel) wrote with the
// 128-byte swizzle, splits it, and passes hi and lo as two A operands. B
// comes from shared memory as two K-major planes, hi and lo, that the
// wrapper splits once a call (the weights) or the kernel writes (the
// weight-gradient reduction's transposed tile).
//
// Tile layout (as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it): rows of 32
// floats (128 bytes), 1024-byte aligned; element (r, c), c < 32, at byte
//   r * 128 + (((c / 4) ^ (r % 8)) * 16) + (c % 4) * 4.
// A K-major B tile read by a descriptor of layout type 1 (B128): 8-row
// groups 1024 bytes apart; a k8 step advances the start by 32 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr int KS = 32;  // reduction depth of a tile row: 32 floats, 128 bytes

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return r * ROW_BYTES + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// A's fragment of one k8 step, split: the thread's four values of a 64 x 8
// block of A (wgmma's register layout for .tf32: warp w of the warpgroup
// holds rows 16 w + [0, 16); a0 (row g, col t), a1 (row g + 8, col t), a2
// (row g, col t + 4), a3 (row g + 8, col t + 4), g = lane / 4, t = lane % 4).
// `at(row, col)` is the shared-memory address of A's element.
struct Frag {
  uint32_t hi[4], lo[4];
};
template <class At>
__device__ __forceinline__ Frag load_frag(At at, int kk) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r = 16 * w + (lane >> 2), c = 8 * kk + (lane & 3);
  Frag f;
  split_tf32(ld_shared_f32(at(r, c)), f.hi[0], f.lo[0]);
  split_tf32(ld_shared_f32(at(r + 8, c)), f.hi[1], f.lo[1]);
  split_tf32(ld_shared_f32(at(r, c + 4)), f.hi[2], f.lo[2]);
  split_tf32(ld_shared_f32(at(r + 8, c + 4)), f.hi[3], f.lo[3]);
  return f;
}

#define WST_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WST_A4 "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// d (64 x N, N / 2 floats a thread) = A (64 x 8, registers) B (8 x N, a
// K-major shared-memory tile) + (add ? d : 0): one TF32 wgmma
template <int N>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint64_t b, int add);
template <>
__device__ __forceinline__ void mma_tf32<64>(float* d, const uint32_t* a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WST_F8(0), WST_F8(8), WST_F8(16), WST_F8(24)
      : WST_A4, "l"(b), "r"(add));
}
template <>
__device__ __forceinline__ void mma_tf32<128>(float* d, const uint32_t* a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WST_F8(0), WST_F8(8), WST_F8(16), WST_F8(24), WST_F8(32), WST_F8(40), WST_F8(48),
        WST_F8(56)
      : WST_A4, "l"(b), "r"(add));
}
#undef WST_A4
#undef WST_F8

// s = A B over one 32-deep step (the four k8 fragments f), as the split's
// products: first the cross terms A_hi B_lo + A_lo B_hi of every k8 step,
// then A_hi B_hi. B's hi and lo planes are K-major tiles of N rows at b_hi
// and b_lo. The caller adds s to its float32 sum (add_step).
//
// The order and the step are for the tensor core's adder, which truncates:
// it aligns the products and the accumulator to the largest of them and
// drops the bits below float32's precision. Cross terms (~2^-11 of hi hi)
// added into a hi hi sum would lose most of their bits at every product;
// summed first, among themselves, they keep them. And a sum over a long
// reduction would drift toward zero (the same sign at every add): summing
// each step apart and adding the steps with FADD, which rounds to nearest,
// keeps the drift to one step's sum.
template <int N>
__device__ __forceinline__ void mma_step(float* s, const Frag* f, uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_tf32<N>(s, f[kk].hi, desc_b128(b_lo + 32 * kk), kk > 0);
    mma_tf32<N>(s, f[kk].lo, desc_b128(b_hi + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_tf32<N>(s, f[kk].hi, desc_b128(b_hi + 32 * kk), 1);
}

// acc += s, once the step's products have completed
template <int N>
__device__ __forceinline__ void add_step(float* acc, float* s) {
  fence_regs<N>(s);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += s[i];
}

// ---- mbarriers and TMA --------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a tensor map into shared memory at dst; its bytes complete_tx
// on bar. Elements outside the tensor (negative or past-the-end
// coordinates) are written as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Warp specialization: a block is NWG consumer warpgroups and one producer
// warpgroup, of which one thread issues the copies. The producer gives its
// registers to the consumers (setmaxnreg, a whole warpgroup at a time), so
// each of an SM's four schedulers holds one producer warp at PRODUCER_REGS
// and two consumer warps at CONSUMER_REGS: (40 + 2 x 232) x 32 <= 16384.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// Named barrier among `count` threads (id 1.. ; 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Two consumer warpgroups take turns to issue their products (named
// barriers 3 and 4): while one's products run, the other waits for its
// own, adds them up and loads its next fragments. Issuing at once, the two
// would stay in step and leave the tensor cores idle between steps. Every
// thread of both warpgroups calls wait() before and pass() after issuing
// one step, and finish() at the end.
template <int NWG>
struct Turns {
  int issued = 0;
  __device__ __forceinline__ void wait() {
    const int wg = threadIdx.x >> 7;
    if (NWG > 1 && (issued > 0 || wg > 0)) bar_sync(3 + wg, 256);
  }
  __device__ __forceinline__ void pass() {
    if (NWG > 1) bar_arrive(3 + (1 - (threadIdx.x >> 7)), 256);
    ++issued;
  }
  __device__ __forceinline__ void finish() {  // takes warpgroup 1's last turn
    if (NWG > 1 && threadIdx.x < 128 && issued > 0) bar_sync(3, 256);
  }
};

// The ring: STAGES slots, a full and an empty barrier each. Step s uses
// slot s % STAGES; its phase parity is (s / STAGES) & 1. The producer waits
// for the slot to be empty (the first round passes at once), arms its full
// barrier with the bytes it copies and issues the copies; each consumer warp
// waits for full and, done with the slot, arrives on empty.
template <int STAGES>
struct Ring {
  uint32_t full0;  // STAGES full barriers, then STAGES empty ones, 8 bytes each
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8 * (s % STAGES); }
  __device__ __forceinline__ uint32_t empty(int s) const { return full0 + 8 * (STAGES + s % STAGES); }
  __device__ __forceinline__ uint32_t parity(int s) const { return (s / STAGES) & 1; }
  // by one thread, before a __syncthreads
  __device__ __forceinline__ void init(int consumer_warps) const {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(full0 + 8 * (STAGES + i), consumer_warps);
    }
    mbar_init_fence();
  }
  __device__ __forceinline__ void produce(int s, uint32_t bytes) const {
    mbar_wait(empty(s), parity(s) ^ 1);
    mbar_expect_tx(full(s), bytes);
  }
  __device__ __forceinline__ void wait_full(int s) const { mbar_wait(full(s), parity(s)); }
  // by every thread of a consumer warp
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
  }
};

// ---- the weights' hi and lo planes ------------------------------------------
// dst = [hi | lo] of Z matrices (R, Cc), or of their transposes (Cc, R), from
// src, Z row-major (R, Cc) matrices: the K-major B planes of a product.
__global__ void split_planes_kernel(const float* __restrict__ src, float* __restrict__ dst, int Z,
                                    int R, int Cc, int transpose) {
  const size_t per = (size_t)R * Cc, n = (size_t)Z * per;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t z = e / per, m = e % per;  // element m of dst's matrix z
    const size_t i = transpose ? (m % R) * Cc + m / R : m;
    uint32_t hi, lo;
    split_tf32(src[z * per + i], hi, lo);
    dst[e] = __uint_as_float(hi);
    dst[n + e] = __uint_as_float(lo);
  }
}

// Launches split_planes_kernel; returns the floats written (2 Z R Cc)
size_t split_planes(const float* src, float* dst, int Z, int R, int Cc, bool transpose,
                    cudaStream_t st) {
  const size_t n = (size_t)Z * R * Cc;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 1024);
  if (n) split_planes_kernel<<<blocks, 256, 0, st>>>(src, dst, Z, R, Cc, transpose ? 1 : 0);
  return 2 * n;
}

// ---- host: tensor maps ------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver entry point, reached through the runtime
// (the libraries are not linked against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a dense float32 array of `rank` dims (innermost first), boxes
// of `box` elements, 128-byte swizzle, zeros outside. dims[0] * 4 bytes must
// be a multiple of 16, box[0] must be 32 (one swizzled row). 0 or a CUDA
// error code.
int make_map(CUtensorMap* map, const float* base, int rank, const uint64_t* dims,
             const uint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5], e[5];
  uint64_t s = sizeof(float);
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i] > 0 ? dims[i] : 1;
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) strides[i] = s *= d[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), d,
                        strides, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// An activation (B, L, cols), read TM rows of 32 columns a box at (c, t, b)
int map_rows(CUtensorMap* map, const float* base, int B, int L, int cols, int rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)L, (uint64_t)B};
  const uint32_t box[3] = {(uint32_t)KS, (uint32_t)rows, 1};
  return make_map(map, base, 3, dims, box);
}

// Weight planes (2, Z, halves, rows, K): the hi planes of Z matrices, then
// their lo planes; each matrix's rows in `halves` blocks of `rows` (the gate's
// tanh and sigmoid rows, the 1x1's residual and skip rows). A box is `n`
// rows of 32 K columns at (k, row, half, plane * Z + z).
int map_weights(CUtensorMap* map, const float* base, int Z, int halves, int rows, int K, int n) {
  const uint64_t dims[4] = {(uint64_t)K, (uint64_t)rows, (uint64_t)halves, 2 * (uint64_t)Z};
  const uint32_t box[4] = {(uint32_t)KS, (uint32_t)n, 1, 1};
  return make_map(map, base, 4, dims, box);
}

}  // namespace
