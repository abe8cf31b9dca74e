// Fused gated residual block, causal or centred, backward, float32, on
// Hopper's tensor cores (sm_90a). The bf16 form is fused_block_bwd_bf16.cu.
//
// Replaces the Pallas TPU kernel wavenet_speech_tpu/ops/pallas/
// residual_block.py (_bwd_kernel, :201, launched by _pallas_bwd), which is
// causal only. The forward (fused_block.cu) saves only x and the weights;
// this recomputes the gate. With the tap origin R (0 for a causal block, the
// right pad for a centred one; fused_block.cu):
//
//   g    = sum_tap x[t - s_tap] @ Wg[tap] + bg,   s_tap = (K-1-tap) * d - R
//   th   = tanh(g[:, :C]),  sg = sigmoid(g[:, C:]),  act = th * sg
//   do   = [dresid | dskip]                                     (L, 2C)
//   da   = do @ Wo^T
//   dg   = [da * sg * (1 - th^2) | da * th * sg * (1 - sg)]      (L, 2C)
//   dx   = sum_tap dg[t + s_tap] @ Wg[tap]^T + dresid @ Wr^T
//   dWg[tap] = sum_t x[t - s_tap]^T dg[t],  dbg = sum_t dg[t]
//   dWo  = sum_t act[t]^T do[t],            dbo = sum_t do[t]
//   dWr  = sum_t x[t]^T dresid[t],          dbr = sum_t dresid[t]
//
// What bounds it on an H100: at the bench shape (B=8, L=4505, C_in=C=256,
// K=2) a call is 85.0 GFLOP against ~150 MB of inputs and outputs (0.05 ms
// at 3.35 TB/s), so operations bound it: 1.27 ms on the CUDA cores at 67
// TFLOP/s, 0.515 ms as float32-accurate split products on the tensor cores
// (3 TF32 products each, 495 TFLOP/s). Every float32 product here is such a
// split product (tma_tf32.cuh), within a few units of float32's rounding;
// no product takes a single TF32 pass.
//
// What the design does about it. Every pass is a block of two consumer
// warpgroups (64 rows each) and one producer warpgroup, one thread of which
// keeps TMA copies in flight into a ring of mbarrier-guarded slots (the
// producer gives its registers to the consumers with setmaxnreg); the
// consumers issue wgmma with no block barrier a step, summing each 32-deep
// step apart and adding it in float32 (mma_step, add_step: the tensor
// core's adder truncates); in the row products they take turns to issue
// (Turns). Weights are split once a call into K-major
// hi and lo planes (split_planes), read as B; activations are read by TMA
// through 3-D maps over (channels, L, B), so a tap's rows before 0 or from L
// on of a sequence arrive as zeros (TMA's out-of-bounds fill) and never as
// another sequence's rows; a step whose rows all lie outside is skipped, by
// producer and consumers alike (in (c) not where the step's B columns feed
// a bias sum). The row products, (a) and (b), are
// persistent: at most one block an SM walks their (output chunk, row tile)
// units, so the last wave is at most one unit short.
//  (a) da = [dresid | dskip] @ Wo^T as a row product into float32 scratch;
//      then the gate recomputed 64 channel pairs a chunk (the tanh and
//      sigmoid rows of Wg^T as two 64-row B tiles, accumulators that pair
//      up element by element), and an epilogue with da that writes dg
//      (B, L, 2C) and act (B, L, C) float32 to scratch. The TPU kernel
//      recomputes the gate over a window of one halo past its tile, because
//      dx needs dg from future frames; at d = 512 that would recompute it
//      5x here, so the gate is recomputed for a block's own rows only and dg
//      goes through device memory (75 + 37 MB at the bench shape).
//  (b) dx as a row product: dg shifted by +s_tap against Wg[tap] (K-major
//      as stored), dresid against Wr, 128 input channels a chunk.
//  (c) the weight gradients: a reduction over the frames. Its operands are
//      MN-major as stored (frames x channels), and a TF32 wgmma reads B only
//      K-major, so B is transposed while staging: the consumers read the
//      TMA'd (32 frames x 128 columns) B tile, split it and write hi and lo
//      K-major with st.shared (lane f takes frame f and column f ^ k: no
//      bank conflict on the read or the write), into one of two buffers,
//      while the previous step's products run. A comes from registers,
//      gathered from its MN-major tile; a warp's 16 rows are assigned the
//      channels that make that gather conflict-free too (chan_of). Of the
//      three ways (this; dg and act written pre-split and transposed by
//      (a); three bf16 parts with the MN-major bf16 descriptors), this one
//      alone needs no extra planes and covers dWr, whose operands are both
//      inputs. The TPU kernel sums the weight gradients across its
//      sequential grid in VMEM; here each block sums its (128 x 128 tile,
//      frame slice) over NSLICE fixed slices of (sequence, 32-frame) steps,
//      the bias sums add the raw B tile's columns on the CUDA cores, and
//  (d) adds the slices in slice order. No float atomics: the same inputs
//      give the same bits on every run.
//
// Requires C_in % 32 == 0 and C % 32 == 0 (the wrapper zero-pads other
// widths; 32 columns are one TMA box and one swizzled row), contiguous
// float tensors aligned to 16 bytes. Any K >= 1: the row products take any
// number of terms, and pass (c) takes MAX_TAPS + 2 products a launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>
#include <vector>

#include "common.cuh"
#include "tma_tf32.cuh"

namespace {

constexpr int NWG = 2;                // consumer warpgroups, 64 rows each
constexpr int CWARPS = 4 * NWG;       // consumer warps
constexpr int NT = 128 * NWG + 128;   // and one producer warpgroup
constexpr int TM = 64 * NWG;          // rows of a row-product block
constexpr int A_BYTES = TM * ROW_BYTES;      // A: TM rows of 32 floats
constexpr int B_BYTES = 2 * 128 * ROW_BYTES;  // B: hi and lo planes of 128 rows
constexpr int SLOT = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr size_t SMEM = 1024 + (size_t)STAGES * SLOT + 16 * STAGES;
// (c): steps of FR frames; (WT x WT) output tiles; a raw box is 32 frames x
// 32 columns; a slot holds four boxes of A and four of B
constexpr int FR = 32, WT = 128, RAW = FR * ROW_BYTES;
constexpr int SLOT_W = 8 * RAW;
constexpr int T_BYTES = 2 * WT * ROW_BYTES;  // B transposed: hi and lo planes
constexpr int STAGES_W = 4;
constexpr size_t SMEM_W = 1024 + (size_t)STAGES_W * SLOT_W + 2 * T_BYTES + 16 * STAGES_W;
constexpr int NSLICE = 9;  // (c): 28 tiles x 9 slices = 252 blocks at the bench shape
constexpr int MAX_TAPS = 8;

// ---- (a), (b) row products: out[t] = sum_terms A[t + shift] . W^T, per sequence
// Term set 0: ntap terms, term j reads A map a[0] shifted by
// shift_step * (ntap - 1 - j) + origin rows against matrix j of weight map
// w[0], k0 columns each. Term set 1 (k1 > 0): A map a[1] against w[1]'s matrix 0 from
// its column w1_koff, k1 columns. GATE: the gate recompute, N channel pairs,
// B tiles of 64 tanh and 64 sigmoid rows, and the dg / act epilogue;
// otherwise N output channels, B tiles of 128 rows, stored to out.
struct RowsParams {
  CUtensorMap a[2];  // (cols, L, B), boxes of TM rows
  CUtensorMap w[2];  // weight planes (map_weights), boxes of 64 (GATE) or 128 rows
  int z[2];          // matrices of w[0], w[1] (the lo planes start at z)
  int ntap, k0, k1, w1_koff, shift_step, origin, B, L, N;
  float* out;
  const float* gate_b;  // GATE: gate_b (2C), da (B, L, C) in; dg (B, L, 2C), act (B, L, C) out
  const float* da;
  float *dg, *act;
};

struct RStep {
  int set, z, acol, wcol, shift;
};

__device__ __forceinline__ RStep rows_step(const RowsParams& p, int u) {
  const int n0 = p.k0 / KS;
  if (u < p.ntap * n0) {
    const int j = u / n0, c = (u % n0) * KS;
    return RStep{0, j, c, c, p.shift_step * (p.ntap - 1 - j) + p.origin};
  }
  const int c = (u - p.ntap * n0) * KS;
  return RStep{1, 0, c, p.w1_koff + c, 0};
}

template <bool GATE>
__global__ void __launch_bounds__(NT, 1) bwd_rows_kernel(const __grid_constant__ RowsParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw);
  const Ring<STAGES> rg{ring + STAGES * SLOT};
  constexpr int NCH = GATE ? 64 : 128;  // output channels (GATE: pairs) a chunk
  // Unit u: output chunk u / tiles of row tile u % tiles (a sequence's TM
  // rows). The blocks, at most one an SM, walk the units in steps of
  // gridDim.x, so the last wave is at most one unit short.
  const int nt = cdiv(p.L, TM), tiles = nt * p.B, units = cdiv(p.N, NCH) * tiles;
  const int per = p.ntap * (p.k0 / KS) + p.k1 / KS;
  auto unit = [&](int u, int& n0, int& b, int& t0) {
    n0 = (u / tiles) * NCH, b = (u % tiles) / nt, t0 = (u % tiles) % nt * TM;
  };
  // a step whose TM rows of A all lie outside [0, L) adds nothing
  auto skip = [&](const RStep& st, int t0) { return t0 + st.shift + TM <= 0 || t0 + st.shift >= p.L; };
  if (threadIdx.x == 0) rg.init(CWARPS);
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {  // the producer warpgroup: one thread issues every copy
    producer_regs();
    if (threadIdx.x == 128 * NWG) {
      for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x) {
        int n0, b, t0;
        unit(u, n0, b, t0);
        for (int k = 0; k < per; ++k) {
          const RStep st = rows_step(p, k);
          if (skip(st, t0)) continue;
          const int zl = p.z[st.set] + st.z;  // the lo plane of matrix z
          const uint32_t slot = ring + (n % STAGES) * SLOT, bar = rg.full(n), B0 = slot + A_BYTES;
          rg.produce(n++, SLOT);
          tma_load(slot, &p.a[st.set], bar, st.acol, t0 + st.shift, b);
          if (GATE) {
            for (int h = 0; h < 2; ++h) {  // tanh rows, then sigmoid rows: hi, lo each
              tma_load(B0 + (2 * h) * 64 * ROW_BYTES, &p.w[0], bar, st.wcol, n0, h, st.z);
              tma_load(B0 + (2 * h + 1) * 64 * ROW_BYTES, &p.w[0], bar, st.wcol, n0, h, zl);
            }
          } else {
            tma_load(B0, &p.w[st.set], bar, st.wcol, n0, 0, st.z);
            tma_load(B0 + 128 * ROW_BYTES, &p.w[st.set], bar, st.wcol, n0, 0, zl);
          }
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x >> 7;
  // the unit's sum and a step's (mma_step): GATE tanh [0, 32), sigmoid
  // [32, 64) (m64n64 each); else m64n128
  float acc[64], sa[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sa[i] = 0.f;
  Turns<NWG> turns;
  for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x) {
    int n0, b, t0;
    unit(u, n0, b, t0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int k = 0; k < per; ++k) {
      if (skip(rows_step(p, k), t0)) continue;
      const uint32_t slot = ring + (n % STAGES) * SLOT, A = slot + wg * 64 * ROW_BYTES;
      const uint32_t B0 = slot + A_BYTES;
      rg.wait_full(n);
      Frag f[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) f[kk] = load_frag([&](int r, int c) { return A + swz32(r, c); }, kk);
      turns.wait();
      wg_fence();
      if (GATE) {
        mma_step<64>(sa, f, B0, B0 + 64 * ROW_BYTES);
        mma_step<64>(sa + 32, f, B0 + 128 * ROW_BYTES, B0 + 192 * ROW_BYTES);
      } else {
        mma_step<128>(sa, f, B0, B0 + 128 * ROW_BYTES);
      }
      wg_commit();
      turns.pass();
      wg_wait<0>();
      add_step<64>(acc, sa);
      rg.release(n++);
    }

    if (GATE) {  // th, sg; dg's two halves and act, with da
      const int C = p.N;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int t = t0 + 64 * wg + acc_row(i), ch = n0 + acc_col(i);
        if (t >= p.L || ch >= C) continue;
        const size_t r = (size_t)b * p.L + t;
        const float2 d = *reinterpret_cast<const float2*>(p.da + r * C + ch);
        float gt[2], gs[2], a[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float th = tanhf(acc[i + e] + p.gate_b[ch + e]);
          const float sg = sigmoid_f(acc[32 + i + e] + p.gate_b[C + ch + e]);
          const float de = e ? d.y : d.x;
          gt[e] = de * sg * (1.f - th * th);
          gs[e] = de * th * sg * (1.f - sg);
          a[e] = th * sg;
        }
        *reinterpret_cast<float2*>(p.dg + r * 2 * C + ch) = make_float2(gt[0], gt[1]);
        *reinterpret_cast<float2*>(p.dg + r * 2 * C + C + ch) = make_float2(gs[0], gs[1]);
        *reinterpret_cast<float2*>(p.act + r * C + ch) = make_float2(a[0], a[1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int t = t0 + 64 * wg + acc_row(i), ch = n0 + acc_col(i);
        if (t < p.L && ch < p.N)
          *reinterpret_cast<float2*>(p.out + ((size_t)b * p.L + t) * p.N + ch) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
  }
  turns.finish();
}

// ---- (c) weight gradients: partial sums of A^T B over one frame slice -------
// A and B are (B*L, cols) matrices over the frames: A is map `a` with its
// rows shifted by a_shift frames within each sequence (rows outside the
// sequence read zero); B's columns [0, b_split) are map b0, the rest map
// b1.
struct Job {
  int a, a_shift, a_cols;
  int b0, b1, b_split, b_cols;
  int out;   // offset of the (a_cols, b_cols) result in the gradient layout
  int bias;  // offset of the b_cols column sums of B, or -1
  int tiles_n, tile0;
};
struct WgradParams {
  CUtensorMap m[5];  // x, dg, act, dresid, dskip: (cols, L, B), boxes of FR frames
  Job job[MAX_TAPS + 2];
  int njob, L, B, W, per_slice;  // per_slice: (sequence, FR-frame) steps a slice
  float* part;
};

// The channel (of a warpgroup's 64) that A row r = 16 w + 8 h + g of the
// wgmma fragment stands for: rows g and g + 4 land in other halves of the
// 128-byte swizzle row, so the gather of a fragment from the frames x
// channels tile hits 32 banks
__device__ __forceinline__ int chan_of(int r) {
  const int w = r >> 4, h = (r >> 3) & 1, g = r & 7;
  return 32 * (w >> 1) + 4 * (4 * (g >> 2) + 2 * (w & 1) + h) + (g & 3);
}

__global__ void __launch_bounds__(NT, 1) bwd_wgrad_kernel(const __grid_constant__ WgradParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw), T = ring + STAGES_W * SLOT_W;  // two T buffers
  const Ring<STAGES_W> rg{T + 2 * T_BYTES};
  int ji = 0;
  while (ji + 1 < p.njob && (int)blockIdx.x >= p.job[ji + 1].tile0) ++ji;
  const Job& jb = p.job[ji];
  const int tile = blockIdx.x - jb.tile0;
  const int i0 = (tile / jb.tiles_n) * WT, j0 = (tile % jb.tiles_n) * WT;
  const int nq = cdiv(p.L, FR), q0 = blockIdx.y * p.per_slice;
  const int S = max(0, min(p.B * nq, q0 + p.per_slice) - q0);
  const bool bias = jb.bias >= 0 && i0 == 0;
  // a step whose shifted A rows all lie outside the sequence adds no product;
  // it still adds its B columns to the bias sums
  auto skip = [&](int s) {
    const int t = ((q0 + s) % nq) * FR - jb.a_shift;
    return !bias && (t + FR <= 0 || t >= p.L);
  };
  if (threadIdx.x == 0) rg.init(CWARPS);
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {  // the producer warpgroup
    producer_regs();
    if (threadIdx.x == 128 * NWG) {
      for (int s = 0, n = 0; s < S; ++s) {
        if (skip(s)) continue;
        const int q = q0 + s, b = q / nq, t = (q % nq) * FR;
        const uint32_t slot = ring + (n % STAGES_W) * SLOT_W, bar = rg.full(n);
        // boxes wholly past a matrix's columns are not copied: they feed
        // only output rows or columns that are not stored
        uint32_t bytes = 0;
        for (int u = 0; u < 4; ++u)
          bytes += (i0 + 32 * u < jb.a_cols ? RAW : 0) + (j0 + 32 * u < jb.b_cols ? RAW : 0);
        rg.produce(n++, bytes);
        for (int u = 0; u < 4; ++u) {
          if (i0 + 32 * u < jb.a_cols)
            tma_load(slot + u * RAW, &p.m[jb.a], bar, i0 + 32 * u, t - jb.a_shift, b);
          const int c = j0 + 32 * u;
          if (c < jb.b_cols) {
            const bool lo = c >= jb.b_split;
            tma_load(slot + (4 + u) * RAW, &p.m[lo ? jb.b1 : jb.b0], bar, lo ? c - jb.b_split : c,
                     t, b);
          }
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bcol = threadIdx.x & 127;  // bias: column bcol, frames [16 wg, 16 wg + 16) of a step
  float acc[64], sa[64], bsum = 0.f;  // the tile's sum, a step's (mma_step)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sa[i] = 0.f;
  // Stages the B tile of ring step n into T buffer tb: B^T's hi and lo
  // planes, row 32 u + c holding column c of box u over the 32 frames; adds
  // its columns to the bias sums.
  auto stage_b = [&](int n, uint32_t tb) {
    const uint32_t Braw = ring + (n % STAGES_W) * SLOT_W + 4 * RAW;
    rg.wait_full(n);
    const int u = warp >> 1;
#pragma unroll 4
    for (int k = 16 * (warp & 1); k < 16 * (warp & 1) + 16; ++k) {
      const int c = lane ^ k;
      uint32_t hi, lo;
      split_tf32(ld_shared_f32(Braw + u * RAW + swz32(lane, c)), hi, lo);
      const uint32_t dst = tb + swz32(32 * u + c, lane);
      st_shared_u32(dst, hi);
      st_shared_u32(dst + WT * ROW_BYTES, lo);
    }
    if (bias) {
      const uint32_t col = Braw + (bcol >> 5) * RAW;
#pragma unroll 4
      for (int f = 16 * wg; f < 16 * wg + 16; ++f) bsum += ld_shared_f32(col + swz32(f, bcol & 31));
    }
    fence_async_smem();
  };
  auto next = [&](int s) {  // the next step taken after s
    do ++s;
    while (s < S && skip(s));
    return s;
  };
  // Two T buffers: the next step's B is staged while this step's products run.
  int s = next(-1);
  if (s < S) stage_b(0, T);
  bar_sync(1, 128 * NWG);
  for (int n = 0; s < S; ++n) {
    const uint32_t slot = ring + (n % STAGES_W) * SLOT_W, tb = T + (n & 1) * T_BYTES;
    Frag f[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      f[kk] = load_frag(
          [&](int r, int c) {
            const int ch = 64 * wg + chan_of(r);
            return slot + (ch >> 5) * RAW + swz32(c, ch & 31);
          },
          kk);
    rg.release(n);  // its A is in registers, its B in T
    wg_fence();
    mma_step<128>(sa, f, tb, tb + WT * ROW_BYTES);
    wg_commit();
    s = next(s);
    if (s < S) stage_b(n + 1, T + ((n + 1) & 1) * T_BYTES);
    wg_wait<0>();
    add_step<64>(acc, sa);
    bar_sync(1, 128 * NWG);  // the next T written; every warpgroup done with this one
  }

  float* dst = p.part + (size_t)blockIdx.y * p.W;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = i0 + 64 * wg + chan_of(acc_row(i)), col = j0 + acc_col(i);
    if (r < jb.a_cols && col < jb.b_cols)
      *reinterpret_cast<float2*>(dst + jb.out + (size_t)r * jb.b_cols + col) =
          make_float2(acc[i], acc[i + 1]);
  }
  if (bias) {  // the two halves of each column's frames, added in order
    const uint32_t halves = T;
    if (wg == 1) st_shared_f32(halves + 4 * bcol, bsum);
    bar_sync(1, 128 * NWG);
    if (wg == 0 && j0 + bcol < jb.b_cols)
      dst[jb.bias + j0 + bcol] = bsum + ld_shared_f32(halves + 4 * bcol);
  }
}

// ---- (d) add the slices' partial sums, in slice order ----------------------
__global__ void bwd_slice_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int W) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < W; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < NSLICE; ++k) s += part[(size_t)k * W + e];
    out[e] = s;
  }
}

int launch(const float* x, const float* dresid, const float* dskip, const float* gate_w,
           const float* gate_b, const float* out_w, const float* res_w, float* dx, float* grads,
           float* planes, float* da, float* dg, float* act, float* part, int B, int L, int C_in,
           int C, int K, int dilation, int origin, cudaStream_t st) {
  const int C2 = 2 * C, N = B * L;
  const int o_dbg = K * C_in * C2, o_dwo = o_dbg + C2, o_dbo = o_dwo + C * C2, o_dwr = o_dbo + C2,
            o_dbr = o_dwr + C_in * C, W = o_dbr + C;
  if (N == 0) return (int)cudaMemsetAsync(grads, 0, sizeof(float) * W, st);
  int rc = wst_set_smem(bwd_rows_kernel<false>, SMEM);
  if (!rc) rc = wst_set_smem(bwd_rows_kernel<true>, SMEM);
  if (!rc) rc = wst_set_smem(bwd_wgrad_kernel, SMEM_W);
  if (rc) return rc;
  // the weights' hi and lo planes: Wg^T (gate recompute), Wo (da), Wg (dx), Wr (dx)
  float* wgT_p = planes;
  float* wo_p = wgT_p + split_planes(gate_w, wgT_p, K, C_in, C2, true, st);
  float* wg_p = wo_p + split_planes(out_w, wo_p, 1, C, C2, false, st);
  float* wr_p = wg_p + split_planes(gate_w, wg_p, K, C_in, C2, false, st);
  split_planes(res_w, wr_p, 1, C_in, C, false, st);
  if ((rc = (int)cudaGetLastError())) return rc;

  int dev = 0, sms = 0;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  // persistent row products: at most one block an SM (rows_grid)
  auto rows_grid = [&](int nch, int n) { return std::min(sms, cdiv(n, nch) * cdiv(L, TM) * B); };
  {  // (a) da = dresid @ Wo[:, :C]^T + dskip @ Wo[:, C:]^T
    RowsParams r{};
    if ((rc = map_rows(&r.a[0], dresid, B, L, C, TM)) || (rc = map_rows(&r.a[1], dskip, B, L, C, TM)) ||
        (rc = map_weights(&r.w[0], wo_p, 1, 1, C, C2, 128)) ||
        (rc = map_weights(&r.w[1], wo_p, 1, 1, C, C2, 128)))
      return rc;
    r.z[0] = r.z[1] = 1;
    r.ntap = 1, r.k0 = C, r.k1 = C, r.w1_koff = C, r.shift_step = 0, r.B = B, r.L = L, r.N = C;
    r.out = da;
    bwd_rows_kernel<false><<<rows_grid(128, C), NT, SMEM, st>>>(r);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  {  // (a) the gate, then dg and act
    RowsParams r{};
    if ((rc = map_rows(&r.a[0], x, B, L, C_in, TM)) ||
        (rc = map_weights(&r.w[0], wgT_p, K, 2, C, C_in, 64)))
      return rc;
    r.z[0] = K;
    r.ntap = K, r.k0 = C_in, r.k1 = 0, r.shift_step = -dilation, r.origin = origin, r.B = B;
    r.L = L, r.N = C;
    r.gate_b = gate_b, r.da = da, r.dg = dg, r.act = act;
    bwd_rows_kernel<true><<<rows_grid(64, C), NT, SMEM, st>>>(r);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  {  // (b) dx = sum_tap dg[t + s_tap] @ Wg[tap]^T + dresid @ Wr^T (s_tap with the origin)
    RowsParams r{};
    if ((rc = map_rows(&r.a[0], dg, B, L, C2, TM)) || (rc = map_rows(&r.a[1], dresid, B, L, C, TM)) ||
        (rc = map_weights(&r.w[0], wg_p, K, 1, C_in, C2, 128)) ||
        (rc = map_weights(&r.w[1], wr_p, 1, 1, C_in, C, 128)))
      return rc;
    r.z[0] = K, r.z[1] = 1;
    r.ntap = K, r.k0 = C2, r.k1 = C, r.w1_koff = 0, r.shift_step = dilation, r.origin = -origin;
    r.B = B, r.L = L;
    r.N = C_in, r.out = dx;
    bwd_rows_kernel<false><<<rows_grid(128, C_in), NT, SMEM, st>>>(r);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  // (c) the weight gradients, MAX_TAPS + 2 products a launch (one launch for
  // K <= MAX_TAPS); each writes its own part of the gradient layout
  enum { MX, MDG, MACT, MDR, MDS };
  WgradParams w{};
  const float* srcs[5] = {x, dg, act, dresid, dskip};
  const int cols[5] = {C_in, C2, C, C, C};
  for (int i = 0; i < 5; ++i)
    if ((rc = map_rows(&w.m[i], srcs[i], B, L, cols[i], FR))) return rc;
  std::vector<Job> all;
  auto add = [&](Job j) {
    j.tiles_n = cdiv(j.b_cols, WT);
    all.push_back(j);
  };
  for (int tap = 0; tap < K; ++tap)  // dbg with the last tap (unshifted when causal)
    add(Job{MX, (K - 1 - tap) * dilation - origin, C_in, MDG, MDG, C2, C2, tap * C_in * C2,
            tap == K - 1 ? o_dbg : -1, 0, 0});
  add(Job{MACT, 0, C, MDR, MDS, C, C2, o_dwo, o_dbo, 0, 0});
  add(Job{MX, 0, C_in, MDR, MDR, C, C, o_dwr, o_dbr, 0, 0});
  w.L = L, w.B = B, w.W = W, w.per_slice = cdiv(B * cdiv(L, FR), NSLICE), w.part = part;
  for (size_t first = 0; first < all.size(); first += MAX_TAPS + 2) {
    w.njob = 0;
    int tiles = 0;
    for (size_t i = first; i < std::min(all.size(), first + MAX_TAPS + 2); ++i) {
      Job& j = w.job[w.njob++];
      j = all[i];
      j.tile0 = tiles;
      tiles += cdiv(j.a_cols, WT) * j.tiles_n;
    }
    bwd_wgrad_kernel<<<dim3(tiles, NSLICE), NT, SMEM_W, st>>>(w);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  bwd_slice_sum_kernel<<<cdiv(W, 256), 256, 0, st>>>(part, grads, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch: planes (the weights' hi and lo planes, 2 (2 K C_in 2C + C 2C +
// C_in C) floats), da (B, L, C), dg (B, L, 2C), act (B, L, C), part
// (NSLICE, W) floats, where W is the size of the gradient layout grads =
// [dWg (K, C_in, 2C) | dbg (2C) | dWo (C, 2C) | dbo (2C) | dWr (C_in, C) |
// dbr (C)].
extern "C" int wst_fused_block_bwd_slices() { return NSLICE; }

extern "C" int wst_fused_gated_block_bwd_f32(const float* x, const float* dresid, const float* dskip,
                                             const float* gate_w, const float* gate_b,
                                             const float* out_w, const float* res_w, float* dx,
                                             float* grads, float* planes, float* da, float* dg,
                                             float* act, float* part, int B, int L, int C_in, int C,
                                             int K, int dilation, int origin, void* stream) {
  if (C_in % 32 || C % 32 || C_in <= 0 || C <= 0 || K < 1 || dilation < 1 || B < 0 || L < 0 ||
      origin < 0 || origin > (K - 1) * dilation)
    return (int)cudaErrorInvalidValue;
  return launch(x, dresid, dskip, gate_w, gate_b, out_w, res_w, dx, grads, planes, da, dg, act,
                part, B, L, C_in, C, K, dilation, origin, static_cast<cudaStream_t>(stream));
}
