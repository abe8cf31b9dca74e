// Windowed (banded) softmax attention, float32, on Hopper's tensor cores
// (sm_90a): query i attends to the keys j with i - left <= j <= i + right,
// clipped at the chunk's ends, as Bonito's transformer basecaller runs it
// (ops/window_attention.py; no TPU kernel of the JAX package computes
// attention). Three kernels, each output element written by one block, with
// no atomics, so two runs are bit-equal:
//
//   window_attn_fwd_kernel     (W1)  o and the log-sum-exp lse;
//   window_attn_bwd_dq_kernel  (W2)  delta = rowsum(dO * o) and dq;
//   window_attn_bwd_dkv_kernel (W2)  dk and dv.
//
// What bounds it on an H100: at the train cell's layer (B=32, T=1024, 8
// heads of 64, a band of 256) the forward and backward are 48 GFLOP of
// products against ~100 MB of q, k, v, o, dO and gradients; as split
// products (3 TF32 products each, 495 TFLOP/s) the products bind it. The
// scores never reach device memory: the forward keeps o and lse, the
// backward recomputes the scores of each tile from lse.
//
// What the design does about it:
//  * Every product is a float32-accurate split product on the tensor cores
//    (tma_tf32.cuh: mma_step's three TF32 wgmma a k8 step, A split in
//    registers, B as K-major hi and lo planes in shared memory). A block is
//    one warpgroup; its 64 rows are queries (forward, dq) or keys (dk/dv),
//    and it walks the 32-wide tiles of the other side that meet its band:
//    5 x 64 ... 10 x 32 columns for a band of 256, not T.
//  * The scores' accumulators become the A operand of the next product in
//    registers: a thread's accumulators of a k8 block hold columns 2t and
//    2t + 1 where wgmma's A fragment wants t and t + 4, so the B tile of
//    that product (v, q, dO or k, transposed into shared memory) takes its
//    rows in that order within each 8 (perm). P and dS never leave the
//    registers.
//  * Each block stages its own rows once (raw float32, split as A fragments
//    at each use) and each step's 32 rows of the other side twice, K-major
//    and transposed, split into hi and lo as they are stored. Those rows
//    are fetched into registers a step ahead, so their loads run under the
//    step before's products. 48-96 KB of shared memory and ~200 registers
//    a thread: two blocks an SM.
//  * Rows and columns outside [0, T) load as zeros and are masked; masked
//    scores take the online softmax's finite minus infinity (-1e30) and a
//    probability of 0.
// Requires dh = 64, rows of q, k, v with unit stride on dh and 16-byte
// aligned; o, dO, dq, dk, dv contiguous (B, T, H, 64); lse, delta (B, H, T).

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "tma_tf32.cuh"

namespace {

constexpr int D = 64;                 // the head's width: two 32-float tile rows
constexpr int BM = 64;                // a block's own rows (one warpgroup's M)
constexpr int BN = 32;                // the other side's rows a step
constexpr int SUB = 64 * ROW_BYTES;   // a 64-row tile of 32 floats
constexpr int BT = BN * ROW_BYTES;    // a 32-row tile of 32 floats
constexpr float MASKED = -1e30f;

// d (64 x 32, 16 floats a thread) = A (64 x 8, registers) B (8 x 32, a
// K-major shared-memory tile) + (add ? d : 0)
template <>
__device__ __forceinline__ void mma_tf32<32>(float* d, const uint32_t* a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

struct Params {
  const float *q, *k, *v, *o, *dout, *lse_in;
  float *o_out, *lse, *delta, *dq, *dk, *dv;
  long long sq[3], sk[3], sv[3];  // strides of (b, t, h), floats
  int H, T, left, right;
  float scale;
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t* x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x[0]), "r"(x[1]),
               "r"(x[2]), "r"(x[3])
               : "memory");
}

// The column of a transposed tile that holds source row e: within each 8,
// rows 2t and 2t + 1 go to columns t and t + 4 (the A fragment's order of
// the accumulators' columns; frags_of).
__device__ __forceinline__ int perm(int e) { return (e & ~7) | ((e & 7) >> 1) | ((e & 1) << 2); }

__device__ __forceinline__ float4 ld_row4(const float* src, long long ld, int row, int T, int c) {
  if (row >= T) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(src + (size_t)row * ld + c));
}

// Rows [r0, r0 + 64) of a (T, 64) matrix at src (row stride ld), raw, into
// two swizzled tiles at dst (dh halves, SUB apart): the A side of a product.
__device__ __forceinline__ void load_raw(uint32_t dst, const float* src, long long ld, int r0,
                                         int T) {
#pragma unroll
  for (int it = 0; it < BM * D / 4 / 128; ++it) {
    const int id = it * 128 + threadIdx.x, e = id & 63, c = (id >> 6) * 4;
    const float4 x = ld_row4(src, ld, r0 + e, T, c);
    const uint32_t u[4] = {__float_as_uint(x.x), __float_as_uint(x.y), __float_as_uint(x.z),
                           __float_as_uint(x.w)};
    st_shared_v4(dst + (c >> 5) * SUB + swz32(e, c & 31), u);
  }
}

// A step's 32 rows of the other side, fetched into registers one step
// ahead of their use (the loads run on under the step's products): rows
// [r0, r0 + 32) of a (T, 64) matrix at src, a thread's 4 pieces of 4 floats
constexpr int PIECES = BN * D / 4 / 128;
struct Rows {
  float4 x[PIECES];
};
__device__ __forceinline__ void fetch(Rows& rows, const float* src, long long ld, int r0, int T) {
#pragma unroll
  for (int it = 0; it < PIECES; ++it) {
    const int id = it * 128 + threadIdx.x;
    rows.x[it] = ld_row4(src, ld, r0 + (id & 31), T, (id >> 5) * 4);
  }
}

// The fetched rows split into hi and lo as B operands: if rm, K-major (32
// rows, K = dh; plane pl, half hf at rm + (2 pl + hf) BT); if tr,
// transposed (64 dh rows, K = the 32 rows in perm's order; plane pl at
// tr + pl SUB).
__device__ __forceinline__ void stash(const Rows& rows, uint32_t rm, uint32_t tr) {
#pragma unroll
  for (int it = 0; it < PIECES; ++it) {
    const int id = it * 128 + threadIdx.x, e = id & 31, c = (id >> 5) * 4;
    const float xs[4] = {rows.x[it].x, rows.x[it].y, rows.x[it].z, rows.x[it].w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(xs[j], hi[j], lo[j]);
    if (rm) {
      const uint32_t at = rm + (c >> 5) * BT + swz32(e, c & 31);
      st_shared_v4(at, hi);
      st_shared_v4(at + 2 * BT, lo);
    }
    if (tr) {
      const int pc = perm(e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st_shared_u32(tr + swz32(c + j, pc), hi[j]);
        st_shared_u32(tr + SUB + swz32(c + j, pc), lo[j]);
      }
    }
  }
}

// The A fragments of one 32-deep step from a 64 x 32 accumulator (m64n32):
// k8 block kk's columns 8 kk + 2t, 8 kk + 2t + 1 as the fragment's t, t + 4
__device__ __forceinline__ void frags_of(const float* x, Frag* f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float v[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(v[j], f[kk].hi[j], f[kk].lo[j]);
  }
}

// d (64 x 32) = one 32-deep half of A B^T: A's raw tile at a, B's hi and lo
// tiles at b_hi, b_lo
__device__ __forceinline__ void half_step(float* d, uint32_t a, uint32_t b_hi, uint32_t b_lo) {
  Frag f[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) f[kk] = load_frag([&](int r, int c) { return a + swz32(r, c); }, kk);
  wg_fence();
  mma_step<32>(d, f, b_hi, b_lo);
  wg_commit();
  wg_wait<0>();
  fence_regs<16>(d);
}

// s (64 x 32) = A B^T over dh: A the raw tiles at a (this block's 64 rows),
// B the K-major hi | lo tiles at b (32 rows); each 32-deep half its own
// split step, the halves added in float32.
__device__ __forceinline__ void scores(float* s, uint32_t a, uint32_t b) {
  float h[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) h[i] = 0.f;
  half_step(s, a, b, b + 2 * BT);
  half_step(h, a + SUB, b + BT, b + 3 * BT);
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] += h[i];
}

// acc (64 x 64) += X B: X a 64 x 32 accumulator in registers, B the
// transposed hi | lo tiles at b (64 dh rows, K = 32 in perm's order)
__device__ __forceinline__ void accumulate(float* acc, const float* x, uint32_t b) {
  Frag f[4];
  frags_of(x, f);
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wg_fence();
  mma_step<64>(s, f, b, b + SUB);
  wg_commit();
  wg_wait<0>();
  fence_regs<32>(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += s[i];
}

// Is (query i, key j) in the band of a chunk of T frames?
__device__ __forceinline__ bool in_band(const Params& p, int i, int j) {
  return i < p.T && j < p.T && j - i >= -p.left && j - i <= p.right;
}

// Stores a 64 x 64 accumulator (times mul) as rows [r0, r0 + 64) of a
// contiguous (B, T, H, 64) tensor at head (b, h)
__device__ __forceinline__ void store_rows(float* out, const Params& p, int b, int h, int r0,
                                           const float* acc, float mul) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = r0 + acc_row(i);
    if (r < p.T)
      *reinterpret_cast<float2*>(out + (((size_t)b * p.T + r) * p.H + h) * D + acc_col(i)) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
  }
}

// ---- W1: the forward ---------------------------------------------------------
// Per (64-query tile, b, h): online softmax over the 32-key tiles that meet
// the tile's band. Shared: q raw, k K-major hi | lo, v transposed hi | lo.
constexpr size_t FWD_SMEM = 1024 + 2 * SUB + 4 * BT + 2 * SUB;

__global__ void __launch_bounds__(128) window_attn_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = smem_base(smem_raw), Kb = Qs + 2 * SUB, Vt = Kb + 4 * BT;
  const int m0 = blockIdx.x * BM, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const float* q = p.q + b * p.sq[0] + h * p.sq[2];
  const float* k = p.k + b * p.sk[0] + h * p.sk[2];
  const float* v = p.v + b * p.sv[0] + h * p.sv[2];
  load_raw(Qs, q, p.sq[1], m0, p.T);
  float acc[32], s[16], mrow[2] = {MASKED, MASKED}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  const int lo = max(m0 - p.left, 0) / BN * BN, hi = min(m0 + BM + p.right, p.T);
  Rows kr, vr;
  fetch(kr, k, p.sk[1], lo, p.T);
  fetch(vr, v, p.sv[1], lo, p.T);
  for (int n0 = lo; n0 < hi; n0 += BN) {
    __syncthreads();  // every product on the previous tiles has completed
    stash(kr, Kb, 0);
    stash(vr, 0, Vt);
    fence_async_smem();
    __syncthreads();
    if (n0 + BN < hi) {
      fetch(kr, k, p.sk[1], n0 + BN, p.T);
      fetch(vr, v, p.sv[1], n0 + BN, p.T);
    }
    scores(s, Qs, Kb);
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = in_band(p, m0 + acc_row(i), n0 + acc_col(i)) ? s[i] * p.scale : MASKED;
      mx[r] = fmaxf(mx[r], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(mrow[r] - mx[r]);
      lrow[r] *= alpha[r];
      mrow[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = in_band(p, m0 + acc_row(i), n0 + acc_col(i)) ? expf(s[i] - mx[r]) : 0.f;
      lrow[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    accumulate(acc, s, Vt);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // each thread summed its own columns
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = m0 + acc_row(i);
    const float inv = 1.f / lrow[(i >> 1) & 1];
    if (r < p.T)
      *reinterpret_cast<float2*>(p.o_out + (((size_t)b * p.T + r) * p.H + h) * D + acc_col(i)) =
          make_float2(acc[i] * inv, acc[i + 1] * inv);
  }
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + acc_row(2 * r);
      if (row < p.T) p.lse[(size_t)bh * p.T + row] = mrow[r] + logf(lrow[r]);
    }
  }
}

// ---- W2: dq ------------------------------------------------------------------
// Per (64-query tile, b, h): delta = rowsum(dO * o), then over the 32-key
// tiles of the band: S = q k^T, dP = dO v^T, dS = P (dP - delta),
// dq += dS k. Shared: q and dO raw, k and v K-major, k transposed.
constexpr size_t DQ_SMEM = 1024 + 4 * SUB + 8 * BT + 2 * SUB + 2 * BM * 4;

__global__ void __launch_bounds__(128) window_attn_bwd_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = smem_base(smem_raw), Ds = Qs + 2 * SUB, Kb = Ds + 2 * SUB, Vb = Kb + 4 * BT,
                 Kt = Vb + 4 * BT;
  float* rowv = reinterpret_cast<float*>(smem_ptr(smem_raw, Kt + 2 * SUB));  // lse | delta
  const int m0 = blockIdx.x * BM, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const size_t head = (size_t)h * D, ld = (size_t)p.H * D;  // o, dO: contiguous
  const float* q = p.q + b * p.sq[0] + h * p.sq[2];
  const float* k = p.k + b * p.sk[0] + h * p.sk[2];
  const float* v = p.v + b * p.sv[0] + h * p.sv[2];
  const float* o = p.o + (size_t)b * p.T * ld + head;
  const float* dout = p.dout + (size_t)b * p.T * ld + head;
  load_raw(Qs, q, p.sq[1], m0, p.T);
  load_raw(Ds, dout, ld, m0, p.T);
  {  // delta: two threads a row, 32 columns each
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32, row = m0 + r;
    float d = 0.f;
    if (row < p.T)
      for (int c = c0; c < c0 + 32; ++c) d += o[(size_t)row * ld + c] * dout[(size_t)row * ld + c];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((threadIdx.x & 1) == 0) {
      rowv[BM + r] = d;
      rowv[r] = row < p.T ? p.lse_in[(size_t)bh * p.T + row] : 0.f;
      if (row < p.T) p.delta[(size_t)bh * p.T + row] = d;
    }
  }
  __syncthreads();
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = rowv[acc_row(2 * r)];
    delta[r] = rowv[BM + acc_row(2 * r)];
  }
  float acc[32], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
  const int lo = max(m0 - p.left, 0) / BN * BN, hi = min(m0 + BM + p.right, p.T);
  Rows kr, vr;
  fetch(kr, k, p.sk[1], lo, p.T);
  fetch(vr, v, p.sv[1], lo, p.T);
  for (int n0 = lo; n0 < hi; n0 += BN) {
    __syncthreads();
    stash(kr, Kb, Kt);
    stash(vr, Vb, 0);
    fence_async_smem();
    __syncthreads();
    if (n0 + BN < hi) {
      fetch(kr, k, p.sk[1], n0 + BN, p.T);
      fetch(vr, v, p.sv[1], n0 + BN, p.T);
    }
    scores(s, Qs, Kb);
    scores(dp, Ds, Vb);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      const float pr = in_band(p, m0 + acc_row(i), n0 + acc_col(i)) ? expf(s[i] * p.scale - lse[r]) : 0.f;
      s[i] = pr * (dp[i] - delta[r]);
    }
    accumulate(acc, s, Kt);
  }
  store_rows(p.dq, p, b, h, m0, acc, p.scale);
}

// ---- W2: dk, dv --------------------------------------------------------------
// Per (64-key tile, b, h), over the 32-query tiles whose band holds these
// keys (j - right <= i <= j + left): S^T = k q^T, P^T, dv += P^T dO,
// dP^T = v dO^T, dS^T = P^T (dP^T - delta), dk += dS^T q. Shared: k and v
// raw; q and dO K-major and transposed; the tile's lse and delta.
constexpr size_t DKV_SMEM = 1024 + 4 * SUB + 8 * BT + 4 * SUB + 2 * BN * 4;

__global__ void __launch_bounds__(128) window_attn_bwd_dkv_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Ks = smem_base(smem_raw), Vs = Ks + 2 * SUB, Qb = Vs + 2 * SUB, Db = Qb + 4 * BT,
                 Qt = Db + 4 * BT, Dt = Qt + 2 * SUB;
  float* colv = reinterpret_cast<float*>(smem_ptr(smem_raw, Dt + 2 * SUB));  // lse | delta
  const int n0 = blockIdx.x * BM, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const size_t ld = (size_t)p.H * D;
  const float* q = p.q + b * p.sq[0] + h * p.sq[2];
  const float* k = p.k + b * p.sk[0] + h * p.sk[2];
  const float* v = p.v + b * p.sv[0] + h * p.sv[2];
  const float* dout = p.dout + (size_t)b * p.T * ld + (size_t)h * D;
  load_raw(Ks, k, p.sk[1], n0, p.T);
  load_raw(Vs, v, p.sv[1], n0, p.T);
  float dk[32], dv[32], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
  const int lo = max(n0 - p.right, 0) / BN * BN, hi = min(n0 + BM + p.left, p.T);
  Rows qr, dr;
  fetch(qr, q, p.sq[1], lo, p.T);
  fetch(dr, dout, ld, lo, p.T);
  for (int m0 = lo; m0 < hi; m0 += BN) {
    __syncthreads();
    stash(qr, Qb, Qt);
    stash(dr, Db, Dt);
    if (threadIdx.x < 2 * BN) {
      const int c = threadIdx.x & (BN - 1), row = m0 + c;
      const float* src = threadIdx.x < BN ? p.lse_in : p.delta;
      colv[threadIdx.x] = row < p.T ? src[(size_t)bh * p.T + row] : 0.f;
    }
    fence_async_smem();
    __syncthreads();
    if (m0 + BN < hi) {
      fetch(qr, q, p.sq[1], m0 + BN, p.T);
      fetch(dr, dout, ld, m0 + BN, p.T);
    }
    scores(s, Ks, Qb);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = acc_col(i);
      s[i] = in_band(p, m0 + c, n0 + acc_row(i)) ? expf(s[i] * p.scale - colv[c]) : 0.f;
    }
    accumulate(dv, s, Dt);
    scores(dp, Vs, Db);
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] *= dp[i] - colv[BN + acc_col(i)];
    accumulate(dk, s, Qt);
  }
  store_rows(p.dk, p, b, h, n0, dk, p.scale);
  store_rows(p.dv, p, b, h, n0, dv, 1.f);
}

Params params(const float* q, const float* k, const float* v, const long long* strides, int H,
              int T, int left, int right, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
  }
  p.H = H;
  p.T = T;
  p.left = left;
  p.right = right;
  p.scale = scale;
  return p;
}

}  // namespace

// strides: (b, t, h) of q, then k, then v, in floats
extern "C" int wst_window_attn_fwd(const float* q, const float* k, const float* v,
                                   const long long* strides, float* o, float* lse, int B, int T,
                                   int H, int left, int right, float scale, void* stream) {
  Params p = params(q, k, v, strides, H, T, left, right, scale);
  p.o_out = o;
  p.lse = lse;
  int rc = wst_set_smem(window_attn_fwd_kernel, FWD_SMEM);
  if (rc) return rc;
  const dim3 grid(cdiv(T, BM), B * H);
  window_attn_fwd_kernel<<<grid, 128, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// delta: (B, H, T) scratch, written by the dq kernel and read by the dk/dv one
extern "C" int wst_window_attn_bwd(const float* q, const float* k, const float* v,
                                   const long long* strides, const float* o, const float* dout,
                                   const float* lse, float* delta, float* dq, float* dk, float* dv,
                                   int B, int T, int H, int left, int right, float scale,
                                   void* stream) {
  Params p = params(q, k, v, strides, H, T, left, right, scale);
  p.o = o;
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  int rc = wst_set_smem(window_attn_bwd_dq_kernel, DQ_SMEM);
  if (!rc) rc = wst_set_smem(window_attn_bwd_dkv_kernel, DKV_SMEM);
  if (rc) return rc;
  const dim3 grid(cdiv(T, BM), B * H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  window_attn_bwd_dq_kernel<<<grid, 128, DQ_SMEM, st>>>(p);
  window_attn_bwd_dkv_kernel<<<grid, 128, DKV_SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
