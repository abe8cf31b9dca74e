// Fused gated residual block, causal or centred, backward, bf16, on
// Hopper's tensor cores (sm_90a).
//
// Replaces the bf16 form of the Pallas TPU kernel wavenet_speech_tpu/ops/
// pallas/residual_block.py (_bwd_kernel, :245-300, launched by _pallas_bwd,
// casts :382-384), which is causal only. It recomputes the gate from x, as
// the TPU kernel does; R is the tap origin (0 for a causal block, the right
// pad for a centred one; fused_block.cu):
//
//   g    = sum_tap x[t - s_tap] @ Wg[tap] + bg,   s_tap = (K-1-tap) * d - R
//   th   = tanh(g[:, :C]),  sg = sigmoid(g[:, C:]),  act = th * sg
//   do   = [dresid | dskip];  da = do @ Wo^T
//   dg   = [da * sg * (1 - th^2) | da * th * sg * (1 - sg)]
//   dx   = sum_tap dg[t + s_tap] @ Wg[tap]^T + dresid @ Wr^T
//   dWg[tap] = sum_t x[t - s_tap]^T dg[t],  dbg = sum_t dg[t]
//   dWo  = sum_t act[t]^T do[t],            dbo = sum_t do[t]
//   dWr  = sum_t x[t]^T dresid[t],          dbr = sum_t dresid[t]
//
// x, the weights, dresid and dskip are bf16; dg and act are float32, as in
// the TPU kernel's arithmetic. Products of two bf16 values (x Wg, do Wo^T,
// dresid Wr^T, x^T dresid) run as bf16 wgmma with float32 accumulators,
// exactly. A product with a float32 operand v (dg Wg^T, x^T dg, act^T do)
// runs as two bf16 products over the split v = hi + lo, hi = bf16(v), lo =
// bf16(v - hi), both accumulated in float32: the split carries ~16 bits of
// v, the results are rounded to bf16 (8 bits). dx and the summed gradients
// are stored rounded to bf16.
//
// What bounds it on an H100: at the bench shape (B=8, L=4505, C_in=C=256,
// K=2) the call is 37.8 GFLOP of bf16 x bf16 products plus 2 x 47.2 GFLOP
// for the split ones, 0.134 ms at 989 TFLOP/s, against ~76 MB of inputs and
// outputs (0.023 ms at 3.35 TB/s): operations bound it.
//
// The design, the float32 kernel's passes (fused_block_bwd.cu) on the
// tensor cores, each block two warpgroups of 64 rows:
//  (a) da = [dresid | dskip] @ out_w^T as a row product (below), float32 to
//      scratch; then, per 128 rows, the gate recomputed 128 channel pairs a
//      chunk (two m64n128 over one B tile of gate_w^T's tanh and sigmoid
//      rows) and the float32 epilogue with da, which writes dg and act as
//      bf16 hi and lo planes (the bytes of a float32 copy).
//  (b) dx as a row product: dg's hi and lo planes shifted by +s_tap (rows
//      from L on read zero, within the sequence) against gate_w's rows, and
//      dresid against res_w's rows, 256 input channels a chunk (two
//      m64n128); gate_w and res_w are K-major as stored.
//  (c) the weight gradients, a reduction over the B*L frames cut into
//      NSLICE fixed slices: each block sums its (128 x 128 tile, slice) with
//      wgmma on MN-major tiles (frames are the reduction dimension, so x, dg,
//      act and do are read as stored, with the transpose bits set); a frame
//      t whose t - s_tap lies outside the sequence reads zero for the
//      shifted x. The bias sums
//      add the B tile's columns on the CUDA cores while the product runs.
//  (d) the slices' partial sums added in slice order and rounded to bf16.
// Fixed slices and a fixed order: the result is the same bits on every run.
// Every operand tile comes through cp.async into a ring of slots
// (ring_loop, wgmma.cuh); the epilogues of (a) and (b) leave through a
// shared-memory staging tile as whole 16-byte pieces.
//
// Requires C_in % 8 == 0, C % 8 == 0 (the wrapper zero-pads other widths),
// contiguous bf16 tensors aligned to 16 bytes. Any K >= 1: above MAX_TAPS
// taps, dx is summed in float32 planes of MAX_TAPS taps each (in `part`,
// before (c) uses it) and rounded once, and (c) takes MAX_TAPS + 2
// products a launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NT = 256;  // two warpgroups
constexpr int TM = 128;  // time rows of a (a) or (b) block
constexpr int STAGES = 4;
constexpr int A_BYTES = 128 * ROW_BYTES;
constexpr int SLOT = 3 * A_BYTES;  // A (128 rows) and a 256-row B tile
constexpr int SUB = 64 * ROW_BYTES;     // one 64-row part of a tile
constexpr size_t SMEM = 1024 + (size_t)STAGES * SLOT;
// (c): 2 blocks an SM, A and a 128-row B tile a slot, 512 bytes for the bias halves
constexpr int STAGES_W = 3, SLOT_W = 2 * A_BYTES;
constexpr size_t SMEM_W = 1024 + (size_t)STAGES_W * SLOT_W + 512;
constexpr int NSLICE = 9;  // (c): 28 tiles x 9 = 252 blocks, one wave at the bench shape
constexpr int MAX_TAPS = 8;
constexpr int MAX_TERMS = 2 * MAX_TAPS + 1;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- row products: out[t] = sum_j A_j[t + shift_j] . W_j^T, per sequence -----
// A_j is (B*L, ncols), its columns [0, split) from a0 and the rest from a1;
// rows outside [0, L) of a sequence read zero. W_j is (N, ncols), K-major.
// da (one term) and dx (2K + 1 terms) are such products.
struct Term {
  const bf16* a0;
  const bf16* a1;
  const bf16* w;
  int split, ncols, shift;
};
struct RowsArgs {
  Term term[MAX_TERMS];
  int nterm, L, N;
  float* out_f32;   // the output, float32 ...
  bf16* out_bf16;   // ... or bf16
};

// TM rows x 256 output channels a chunk, two m64n128 products a warpgroup.
__global__ void __launch_bounds__(NT, 1) bwd_rows_kernel(const RowsArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw);
  const int b = blockIdx.y, t0 = blockIdx.x * TM, wg = threadIdx.x >> 7;
  const size_t seq = (size_t)b * a.L;
  int per = 0;
  for (int j = 0; j < a.nterm; ++j) per += cdiv(a.term[j].ncols, TK);
  float acc[2][64];  // output channels 256 q + [0, 128), + [128, 256)

  auto load = [&](int s, uint32_t slot) {
    int u = s % per, j = 0;
    while (u >= cdiv(a.term[j].ncols, TK)) u -= cdiv(a.term[j++].ncols, TK);
    const Term& tm = a.term[j];
    load_rows<NT>(slot, TM, tm.a0 + seq * tm.split, tm.a1 + seq * (tm.ncols - tm.split), tm.split,
                  tm.ncols, t0 + tm.shift, a.L, u * TK);
    load_rows<NT>(slot + A_BYTES, 256, tm.w, tm.w, tm.ncols, tm.ncols, (s / per) * 256, a.N, u * TK);
  };
  auto mma = [&](int s, uint32_t slot) {
    if (s % per == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    }
    wg_fence();
    const uint32_t A = slot + wg * SUB, Bt = slot + A_BYTES;
#pragma unroll
    for (int k = 0; k < TK / 16; ++k) {
      mma_n128(acc[0], desc_b128(A + 32 * k), desc_b128(Bt + 32 * k));
      mma_n128(acc[1], desc_b128(A + 32 * k), desc_b128(Bt + A_BYTES + 32 * k));
    }
  };
  auto last = [&](int s) { return s % per == per - 1; };
  const int warp = threadIdx.x >> 5, row0 = t0 + 64 * wg + 16 * (warp & 3);
  auto epilogue = [&](int s) {
    fence_regs<64>(acc[0]);
    fence_regs<64>(acc[1]);
    __syncthreads();  // every warpgroup is past its products on the slot staged in
    uint8_t* st = smem_ptr(smem_raw, ring + (s % STAGES) * SLOT) + warp * 4096;
    const int nrows = min(16, a.L - row0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col0 = (s / per) * 256 + h * 128;
      if (a.out_bf16) {  // 128 channels a staging tile
#pragma unroll
        for (int i = 0; i < 64; i += 2)
          *reinterpret_cast<uint32_t*>(st + stage_off(frag_row(i), 2 * acc_col(i))) =
              pack2(acc[h][i], acc[h][i + 1]);
        stage_flush(st, reinterpret_cast<uint8_t*>(a.out_bf16 + (seq + row0) * a.N + col0),
                    2 * (size_t)a.N, nrows, 2 * max(0, min(128, a.N - col0)));
      } else {  // float32: 64 channels a staging tile
#pragma unroll
        for (int part = 0; part < 2; ++part) {
#pragma unroll
          for (int i = 32 * part; i < 32 * part + 32; i += 2)
            *reinterpret_cast<float2*>(st + stage_off(frag_row(i), 4 * (acc_col(i) - 64 * part))) =
                make_float2(acc[h][i], acc[h][i + 1]);
          const int c0 = col0 + 64 * part;
          stage_flush(st, reinterpret_cast<uint8_t*>(a.out_f32 + (seq + row0) * a.N + c0),
                      4 * (size_t)a.N, nrows, 4 * max(0, min(64, a.N - c0)));
        }
      }
    }
  };
  ring_loop<STAGES, SLOT>(ring, cdiv(a.N, 256) * per, load, mma, last, epilogue);
}

struct GateArgs {
  const bf16 *x, *wgT, *gate_b;
  const float* da;
  bf16 *dg_hi, *dg_lo, *act_hi, *act_lo;
  int L, C_in, C, K, dilation, origin;
};

// ---- (a) recompute the gate; dg and act as hi/lo planes for TM rows ---------
// Per chunk of 128 channels, the gate's tanh and sigmoid halves (K * nki
// steps, m64n128 each), then the float32 epilogue with da.
__global__ void __launch_bounds__(NT, 1) bwd_gate_kernel(const GateArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw);
  const int b = blockIdx.y, t0 = blockIdx.x * TM, wg = threadIdx.x >> 7;
  const int C = a.C, C2 = 2 * C;
  const int nki = cdiv(a.C_in, TK), per = a.K * nki;
  const bf16* xb = a.x + (size_t)b * a.L * a.C_in;
  float acc[2][64];  // tanh, sigmoid halves

  auto load = [&](int s, uint32_t slot) {
    const int u = s % per, tap = u / nki, c0 = (u % nki) * TK, r0 = (s / per) * 128;
    const bf16* w = a.wgT + (size_t)tap * C2 * a.C_in;
    const bf16* ws = w + (size_t)C * a.C_in;
    load_rows<NT>(slot, TM, xb, xb, a.C_in, a.C_in, t0 - (a.K - 1 - tap) * a.dilation + a.origin,
                  a.L, c0);
    load_rows<NT>(slot + A_BYTES, 128, w, w, a.C_in, a.C_in, r0, C, c0);
    load_rows<NT>(slot + 2 * A_BYTES, 128, ws, ws, a.C_in, a.C_in, r0, C, c0);
  };
  auto mma = [&](int s, uint32_t slot) {
    if (s % per == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    }
    wg_fence();
    const uint32_t A = slot + wg * SUB, Bt = slot + A_BYTES;
#pragma unroll
    for (int k = 0; k < TK / 16; ++k) {
      mma_n128(acc[0], desc_b128(A + 32 * k), desc_b128(Bt + 32 * k));
      mma_n128(acc[1], desc_b128(A + 32 * k), desc_b128(Bt + A_BYTES + 32 * k));
    }
  };
  auto last = [&](int s) { return s % per == per - 1; };
  const int warp = threadIdx.x >> 5, row0 = t0 + 64 * wg + 16 * (warp & 3);
  const auto hi = [](float v) { return __bfloat162float(__float2bfloat16_rn(v)); };
  auto epilogue = [&](int s) {
    fence_regs<64>(acc[0]);
    fence_regs<64>(acc[1]);
    __syncthreads();  // every warpgroup is past its products on the slot staged in
    uint8_t* st = smem_ptr(smem_raw, ring + (s % STAGES) * SLOT) + warp * 4096;
    const int ch0 = (s / per) * 128, nbytes = 2 * min(128, C - ch0), nrows = min(16, a.L - row0);
    // one plane of 128 channels: bf16(v), or the lo part v - bf16(v), of v = val(i)
    auto out = [&](auto val, bool lo, bf16* plane, int ld, int col0) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const float v0 = val(i), v1 = val(i + 1);
        *reinterpret_cast<uint32_t*>(st + stage_off(frag_row(i), 2 * acc_col(i))) =
            lo ? pack2(v0 - hi(v0), v1 - hi(v1)) : pack2(v0, v1);
      }
      stage_flush(st, reinterpret_cast<uint8_t*>(plane + ((size_t)b * a.L + row0) * ld + col0),
                  2 * (size_t)ld, nrows, nbytes);
    };
#pragma unroll
    for (int i = 0; i < 64; ++i) {  // th, sg in place
      const int ch = ch0 + acc_col(i);
      acc[0][i] = tanhf(acc[0][i] + (ch < C ? ld_f(a.gate_b + ch) : 0.f));
      acc[1][i] = sigmoid_f(acc[1][i] + (ch < C ? ld_f(a.gate_b + C + ch) : 0.f));
    }
    const auto act = [&](int i) { return acc[0][i] * acc[1][i]; };
    out(act, false, a.act_hi, C, ch0);
    out(act, true, a.act_lo, C, ch0);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // dg's tanh and sigmoid halves, in place
      const int t = row0 + frag_row(i), ch = ch0 + acc_col(i);
      float2 d = make_float2(0.f, 0.f);
      if (t < a.L && ch < C) d = *reinterpret_cast<const float2*>(a.da + ((size_t)b * a.L + t) * C + ch);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float th = acc[0][i + e], sg = acc[1][i + e], de = e ? d.y : d.x;
        acc[0][i + e] = de * sg * (1.f - th * th);
        acc[1][i + e] = de * th * sg * (1.f - sg);
      }
    }
    const auto dgt = [&](int i) { return acc[0][i]; };
    const auto dgs = [&](int i) { return acc[1][i]; };
    out(dgt, false, a.dg_hi, C2, ch0);
    out(dgt, true, a.dg_lo, C2, ch0);
    out(dgs, false, a.dg_hi, C2, C + ch0);
    out(dgs, true, a.dg_lo, C2, C + ch0);
  };
  ring_loop<STAGES, SLOT>(ring, cdiv(C, 128) * per, load, mma, last, epilogue);
}

// ---- (c) weight gradients: partial sums of A^T B over one frame slice -------
// A and B are (N = B*L, cols) matrices over the frames, read in `np` planes
// (the hi and lo of a split operand; an unsplit operand repeats its one
// plane). B's columns [0, b_split) come from b0, the rest from b1. A's rows
// are shifted by a_shift frames within each sequence (zero outside the
// sequence).
struct Job {
  const bf16* a[2];
  const bf16* b0[2];
  const bf16* b1[2];
  int a_cols, a_shift, b_split, b_cols;
  int np, b_np;  // planes; the bias sums read B's planes [0, b_np)
  int out;       // offset of the (a_cols, b_cols) result in the gradient layout
  int bias;      // offset of the b_cols column sums of B, or -1
  int tiles_n, tile0;
};
struct Jobs {
  Job job[MAX_TAPS + 2];
  int n;
};

__global__ void __launch_bounds__(NT, 2)
    bwd_wgrad_kernel(const Jobs jobs, float* __restrict__ part, int W, int N, int L, int rows_per_slice) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw);
  int ji = 0;
  while (ji + 1 < jobs.n && (int)blockIdx.x >= jobs.job[ji + 1].tile0) ++ji;
  const Job& jb = jobs.job[ji];
  const int tile = blockIdx.x - jb.tile0;
  const int i0 = (tile / jb.tiles_n) * 128, j0 = (tile % jb.tiles_n) * 128;
  const bool bias = jb.bias >= 0 && i0 == 0;
  const int n_begin = blockIdx.y * rows_per_slice, n_end = min(N, n_begin + rows_per_slice);
  const int chunks = n_end > n_begin ? cdiv(n_end - n_begin, 64) : 0;
  const int wg = threadIdx.x >> 7, bcol = threadIdx.x & 127, bhalf = threadIdx.x >> 7;
  float acc[2][32], bsum = 0.f;  // output columns j0 + 64 h + [0, 64)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  auto load = [&](int s, uint32_t slot) {  // 64 frames of A and of B, 2 x 64 columns each
    const int n0 = n_begin + (s / jb.np) * 64, u = s % jb.np, ub = min(u, jb.b_np - 1);
    const bf16* ap = jb.a[u];
    for (int id = threadIdx.x; id < 2 * 64 * 8; id += NT) {
      const int h = id >> 9, f = (id >> 3) & 63, c = (id & 7) * 8;
      const int n = n0 + f, ch = i0 + h * 64 + c, t = n % L - jb.a_shift;
      const bool ok = n < n_end && t >= 0 && t < L && ch < jb.a_cols;
      cp16(slot + h * SUB + swz(f, c), ok ? ap + (size_t)(n - jb.a_shift) * jb.a_cols + ch : ap, ok);
    }
    const bf16 *b0 = jb.b0[ub], *b1 = jb.b1[ub];
    for (int id = threadIdx.x; id < 2 * 64 * 8; id += NT) {
      const int h = id >> 9, f = (id >> 3) & 63, c = (id & 7) * 8;
      const int n = n0 + f, ch = j0 + h * 64 + c;
      const bool ok = n < n_end && ch < jb.b_cols;
      const bf16* p = b0;
      if (ok)
        p = ch < jb.b_split ? b0 + (size_t)n * jb.b_split + ch
                            : b1 + (size_t)n * (jb.b_cols - jb.b_split) + (ch - jb.b_split);
      cp16(slot + A_BYTES + h * SUB + swz(f, c), p, ok);
    }
  };
  auto mma = [&](int s, uint32_t slot) {
    const uint32_t A = slot + wg * SUB, Bt = slot + A_BYTES;
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma_n64_mn(acc[h], desc_b128(A + 2048 * k), desc_b128(Bt + h * SUB + 2048 * k));
    if (bias && s % jb.np < jb.b_np) {  // column bcol of B, frames [32 bhalf, 32 bhalf + 32)
      const uint32_t col = Bt + (bcol >> 6) * SUB;
      for (int f = 32 * bhalf; f < 32 * bhalf + 32; ++f) bsum += ld_shared_bf16(col + swz(f, bcol & 63));
    }
  };
  const int S = chunks * jb.np;
  ring_loop<STAGES_W, SLOT_W>(ring, S, load, mma, [&](int s) { return s == S - 1; }, [&](int) {
    fence_regs<32>(acc[0]);
    fence_regs<32>(acc[1]);
  });

  float* dst = part + (size_t)blockIdx.y * W;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = i0 + wg * 64 + acc_row(i), col = j0 + h * 64 + acc_col(i);
      if (r < jb.a_cols && col < jb.b_cols)
        *reinterpret_cast<float2*>(dst + jb.out + (size_t)r * jb.b_cols + col) =
            make_float2(acc[h][i], acc[h][i + 1]);
    }
  if (bias) {  // the two halves of each column's frames, added in order
    float* halves = reinterpret_cast<float*>(smem_ptr(smem_raw, ring + STAGES_W * SLOT_W));
    if (bhalf == 1) halves[bcol] = bsum;
    __syncthreads();
    if (bhalf == 0 && j0 + bcol < jb.b_cols) dst[jb.bias + j0 + bcol] = bsum + halves[bcol];
  }
}

// ---- (d) add n planes of W partial sums, in plane order, and round to bf16 --
// (the weight gradients' NSLICE slices; dx's tap groups above MAX_TAPS taps)
__global__ void bwd_slice_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                     size_t W, int n) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < W;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += part[(size_t)k * W + e];
    out[e] = __float2bfloat16_rn(s);
  }
}

}  // namespace

// Scratch: dgs (2, B, L, 2C) and acts (2, B, L, C) bf16 (the hi and lo
// planes), da (B, L, C) and part (NSLICE, W) floats, where W is the size of the gradient
// layout grads = [dWg (K, C_in, 2C) | dbg (2C) | dWo (C, 2C) | dbo (2C) |
// dWr (C_in, C) | dbr (C)], stored bf16.
extern "C" int wst_fused_block_bwd_bf16_slices() { return NSLICE; }

extern "C" int wst_fused_gated_block_bwd_bf16(const bf16* x, const bf16* dresid, const bf16* dskip,
                                              const bf16* wgT, const bf16* gate_b, const bf16* out_w,
                                              const bf16* gate_w, const bf16* res_w, bf16* dx,
                                              bf16* grads, bf16* dgs, bf16* acts, float* da,
                                              float* part, int B, int L, int C_in, int C, int K,
                                              int dilation, int origin, void* stream) {
  if (C_in % 8 || C % 8 || C_in <= 0 || C <= 0 || K < 1 || dilation < 1 || B < 0 || L < 0 ||
      origin < 0 || origin > (K - 1) * dilation)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C2 = 2 * C, N = B * L;
  const int o_dbg = K * C_in * C2, o_dwo = o_dbg + C2, o_dbo = o_dwo + C * C2, o_dwr = o_dbo + C2,
            o_dbr = o_dwr + C_in * C, W = o_dbr + C;
  bf16 *dg_hi = dgs, *dg_lo = dgs + (size_t)N * C2, *act_hi = acts, *act_lo = acts + (size_t)N * C;
  int rc = wst_set_smem(bwd_rows_kernel, SMEM);
  if (!rc) rc = wst_set_smem(bwd_gate_kernel, SMEM);
  if (!rc) rc = wst_set_smem(bwd_wgrad_kernel, SMEM_W);
  if (rc) return rc;
  if (N > 0) {
    const dim3 grid(cdiv(L, TM), B);
    RowsArgs r{};  // da = [dresid | dskip] @ out_w^T, float32
    r.term[0] = Term{dresid, dskip, out_w, C, C2, 0};
    r.nterm = 1, r.L = L, r.N = C, r.out_f32 = da;
    bwd_rows_kernel<<<grid, NT, SMEM, st>>>(r);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    bwd_gate_kernel<<<grid, NT, SMEM, st>>>(
        GateArgs{x, wgT, gate_b, da, dg_hi, dg_lo, act_hi, act_lo, L, C_in, C, K, dilation, origin});
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    // dx = sum_tap (dg_hi + dg_lo)[t + s_tap] @ gate_w[tap]^T + dresid @ res_w^T,
    // one product of MAX_TAPS taps at most; more taps sum their groups'
    // float32 planes, in order, in part
    const int groups = cdiv(K, MAX_TAPS);
    const bf16* planes[2] = {dg_hi, dg_lo};
    for (int g = 0; g < groups; ++g) {
      r = RowsArgs{};
      for (int tap = g * MAX_TAPS; tap < std::min(K, (g + 1) * MAX_TAPS); ++tap)
        for (const bf16* plane : planes)
          r.term[r.nterm++] = Term{plane, plane, gate_w + (size_t)tap * C_in * C2, C2, C2,
                                   (K - 1 - tap) * dilation - origin};
      if (g == 0) r.term[r.nterm++] = Term{dresid, dresid, res_w, C, C, 0};
      r.L = L, r.N = C_in;
      if (groups == 1)
        r.out_bf16 = dx;
      else
        r.out_f32 = part + (size_t)g * N * C_in;
      bwd_rows_kernel<<<grid, NT, SMEM, st>>>(r);
      rc = (int)cudaGetLastError();
      if (rc) return rc;
    }
    if (groups > 1) {
      bwd_slice_sum_kernel<<<cdiv(N * C_in, 256), 256, 0, st>>>(part, dx, (size_t)N * C_in,
                                                                groups);
      rc = (int)cudaGetLastError();
      if (rc) return rc;
    }
  }
  std::vector<Job> all;
  auto add = [&](Job j) {
    j.tiles_n = cdiv(j.b_cols, 128);
    all.push_back(j);
  };
  for (int tap = 0; tap < K; ++tap)
    add(Job{{x, x}, {dg_hi, dg_lo}, {dg_hi, dg_lo}, C_in, (K - 1 - tap) * dilation - origin, C2,
            C2, 2, 2, tap * C_in * C2, tap == 0 ? o_dbg : -1, 0, 0});
  add(Job{{act_hi, act_lo}, {dresid, dresid}, {dskip, dskip}, C, 0, C, C2, 2, 1, o_dwo, o_dbo, 0, 0});
  add(Job{{x, x}, {dresid, dresid}, {dresid, dresid}, C_in, 0, C, C, 1, 1, o_dwr, o_dbr, 0, 0});
  const int rows = cdiv(N > 0 ? N : 1, NSLICE);
  // MAX_TAPS + 2 jobs a launch (one launch for K <= MAX_TAPS); each writes
  // its own part of the gradient layout
  for (size_t first = 0; first < all.size(); first += MAX_TAPS + 2) {
    Jobs jobs;
    jobs.n = 0;
    int tiles = 0;
    for (size_t i = first; i < std::min(all.size(), first + MAX_TAPS + 2); ++i) {
      Job& j = jobs.job[jobs.n++];
      j = all[i];
      j.tile0 = tiles;
      tiles += cdiv(j.a_cols, 128) * j.tiles_n;
    }
    bwd_wgrad_kernel<<<dim3(tiles, NSLICE), NT, SMEM_W, st>>>(jobs, part, W, N, L > 0 ? L : 1, rows);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  bwd_slice_sum_kernel<<<cdiv(W, 256), 256, 0, st>>>(part, grads, W, NSLICE);
  return (int)cudaGetLastError();
}
