// Fused causal gated residual block, backward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wavenet_speech_tpu/ops/pallas/
// residual_block.py (_bwd_kernel, launched by _pallas_bwd). The forward
// (fused_block.cu) saves only x and the weights; this recomputes the gate:
//
//   g    = sum_tap x[t - s_tap] @ Wg[tap] + bg,   s_tap = (K-1-tap) * d
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
// K=2) one call is 2 * B*L * (K*C_in*2C [gate] + 2C*C [da] + K*2C*C_in + C*C_in
// [dx] + K*C_in*2C + C*2C + C_in*C [weights]) = 85 GFLOP against ~150 MB of
// inputs and outputs, so it is bound by operations (float32 on the CUDA
// cores: 67 TFLOP/s at 700 W, 1.27 ms), not by bytes (0.05 ms).
//
// What the design does about it, where it differs from the TPU kernel:
//  * The TPU kernel recomputes the gate over its 512-row tile plus a right
//    extension of one halo, because dx needs dg from future frames. With
//    32-row GPU tiles and d = 512 that window would recompute the gate 17x.
//    Here pass (a) recomputes the gate for its own rows only and writes dg
//    (B, L, 2C) and act (B, L, C) to device memory (75 + 37 MB at the bench
//    shape, ~35 us of HBM time), and pass (b) reads dg at any shift.
//  * The TPU kernel sums the weight gradients across its sequential grid in
//    VMEM. A GPU grid runs its blocks at once, and f32 atomics would make the
//    gradients change from run to run. Pass (c) is a reduction GEMM over
//    the B*L frames cut into NSLICE fixed slices: each block writes the
//    partial sum of its (64 x 64 tile, slice), and pass (d) adds the slices
//    in a fixed order. The result is the same bits on every run.
//  * Passes (a) and (b) use the forward's tiling (tile.cuh): 32 rows a block,
//    weights streamed from L2 16 rows deep, 4 x 4 register tiles. Pass (c)
//    streams 16 frames a stage through 64 x 64 tiles of A and B.
//
// The wrapper passes the weights transposed (Wo^T, Wg[tap]^T, Wr^T), so
// every weight tile is read along its rows. Requires C_in % 4 == 0,
// C % 4 == 0, K <= MAX_TAPS, contiguous 16-byte-aligned tensors (checked by
// the Python wrapper).

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr int NSLICE = 16;   // frame slices of the weight-gradient reduction
constexpr int MAX_TAPS = 8;
constexpr int WT = 64;       // weight-gradient output tile (WT x WT)
constexpr int WK = 16;       // frames a stage
constexpr int WNT = 256;     // threads, 16 x 16, each a 4 x 4 register tile

// ---- (a) recompute the gate, then dg and act for TL rows -------------------
__global__ void __launch_bounds__(NT, 2)
bwd_gate_kernel(const float* __restrict__ x, const float* __restrict__ gate_w,
                const float* __restrict__ gate_b, const float* __restrict__ woT,
                const float* __restrict__ dresid, const float* __restrict__ dskip,
                float* __restrict__ dg, float* __restrict__ act, int L, int C_in, int C,
                int K, int dilation) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // (KC, AS)
  float* Bs = As + KC * AS;                      // (KC, BS)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TL;
  const int tx = threadIdx.x % CG;
  const int ty = threadIdx.x / CG;
  const float* xb = x + (size_t)b * L * C_in;
  const float* drb = dresid + (size_t)b * L * C;
  const float* dsb = dskip + (size_t)b * L * C;
  const int C2 = 2 * C;
  float acc0[4][4], acc1[4][4], acc2[4][4];

  for (int p0 = 0; p0 < C; p0 += CH) {
    zero(acc0);  // gate, tanh half      (channels p0 ..)
    zero(acc1);  // gate, sigmoid half   (channels C + p0 ..)
    zero(acc2);  // da = do @ Wo^T       (channels p0 ..)
    for (int tap = 0; tap < K; ++tap) {
      const int shift = (K - 1 - tap) * dilation;
      const float* w_tap = gate_w + (size_t)tap * C_in * C2;
      for (int c0 = 0; c0 < C_in; c0 += KC) {
        load_rows_t(As, xb, xb, C_in, t0 - shift, c0, L, C_in);
        load_w_tile<true>(Bs, w_tap, C2, c0, C_in, p0, C + p0, C - p0, C - p0);
        __syncthreads();
        tile_fma<true>(acc0, acc1, As, Bs, tx, ty);
        __syncthreads();
      }
    }
    for (int k0 = 0; k0 < C2; k0 += KC) {
      load_rows_t(As, drb, dsb, C, t0, k0, L, C2);
      load_w_tile<false>(Bs, woT, C, k0, C2, p0, 0, C - p0, 0);
      __syncthreads();
      tile_fma<false>(acc2, acc2, As, Bs, tx, ty);
      __syncthreads();
    }
    const int col = p0 + tx * 4;
    if (col >= C) continue;
    float bt[4], bs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bt[j] = gate_b[col + j];
      bs[j] = gate_b[C + col + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= L) continue;
      float gt[4], gs[4], a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float th = tanhf(acc0[i][j] + bt[j]);
        const float sg = sigmoid_f(acc1[i][j] + bs[j]);
        const float da = acc2[i][j];
        gt[j] = da * sg * (1.f - th * th);
        gs[j] = da * th * sg * (1.f - sg);
        a[j] = th * sg;
      }
      const size_t r = (size_t)b * L + t;
      *reinterpret_cast<float4*>(dg + r * C2 + col) = make_float4(gt[0], gt[1], gt[2], gt[3]);
      *reinterpret_cast<float4*>(dg + r * C2 + C + col) =
          make_float4(gs[0], gs[1], gs[2], gs[3]);
      *reinterpret_cast<float4*>(act + r * C + col) = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// ---- (b) dx for TL rows, 2 x CH input channels at a time --------------------
__global__ void __launch_bounds__(NT, 2)
bwd_dx_kernel(const float* __restrict__ dg, const float* __restrict__ dresid,
              const float* __restrict__ wgT, const float* __restrict__ wrT,
              float* __restrict__ dx, int L, int C_in, int C, int K, int dilation) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + KC * AS;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TL;
  const int tx = threadIdx.x % CG;
  const int ty = threadIdx.x / CG;
  const int C2 = 2 * C;
  const float* dgb = dg + (size_t)b * L * C2;
  const float* drb = dresid + (size_t)b * L * C;
  float acc0[4][4], acc1[4][4];

  for (int q0 = 0; q0 < C_in; q0 += 2 * CH) {
    zero(acc0);  // dx channels q0 ..
    zero(acc1);  // dx channels q0 + CH ..
    for (int tap = 0; tap < K; ++tap) {
      const int shift = (K - 1 - tap) * dilation;
      const float* w_tap = wgT + (size_t)tap * C2 * C_in;  // (2C, C_in)
      for (int k0 = 0; k0 < C2; k0 += KC) {
        load_rows_t(As, dgb, dgb, C2, t0 + shift, k0, L, C2);
        load_w_tile<true>(Bs, w_tap, C_in, k0, C2, q0, q0 + CH, C_in - q0, C_in - q0 - CH);
        __syncthreads();
        tile_fma<true>(acc0, acc1, As, Bs, tx, ty);
        __syncthreads();
      }
    }
    for (int k0 = 0; k0 < C; k0 += KC) {
      load_rows_t(As, drb, drb, C, t0, k0, L, C);
      load_w_tile<true>(Bs, wrT, C_in, k0, C, q0, q0 + CH, C_in - q0, C_in - q0 - CH);
      __syncthreads();
      tile_fma<true>(acc0, acc1, As, Bs, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= L) continue;
      float* row = dx + ((size_t)b * L + t) * C_in;
      const int ca = q0 + tx * 4;
      const int cb = q0 + CH + tx * 4;
      if (ca < C_in)
        *reinterpret_cast<float4*>(row + ca) =
            make_float4(acc0[i][0], acc0[i][1], acc0[i][2], acc0[i][3]);
      if (cb < C_in)
        *reinterpret_cast<float4*>(row + cb) =
            make_float4(acc1[i][0], acc1[i][1], acc1[i][2], acc1[i][3]);
    }
  }
}

// ---- (c) weight gradients: partial sums of A^T B over one frame slice -------
// A and B are (N = B*L, cols) matrices over the frames, each stored as one
// or two column blocks (see load_rows_t); A's rows are shifted by a_shift
// frames within each sequence (rows before a sequence's start read zero).
struct Job {
  const float* a0;
  const float* a1;
  const float* b0;
  const float* b1;
  int a_split, a_cols, a_shift;
  int b_split, b_cols;
  int out;      // offset of the (a_cols, b_cols) result in the gradient layout
  int bias;     // offset of the b_cols column sums of B, or -1
  int tiles_n;  // tiles along b_cols
  int tile0;    // first tile (blockIdx.x) of this job
};
struct Jobs {
  Job job[MAX_TAPS + 2];
  int n;
};

__device__ __forceinline__ float4 load_cols4(const float* p0, const float* p1, int split,
                                             int cols, size_t row, int c) {
  return c < split ? *reinterpret_cast<const float4*>(p0 + row * split + c)
                   : *reinterpret_cast<const float4*>(p1 + row * (cols - split) + (c - split));
}

__global__ void __launch_bounds__(WNT)
bwd_wgrad_kernel(const Jobs jobs, float* __restrict__ part, int W, int N, int L,
                 int rows_per_slice) {
  __shared__ float4 As4[WK * WT / 4];
  __shared__ float4 Bs4[WK * WT / 4];
  const float* As = reinterpret_cast<const float*>(As4);
  const float* Bs = reinterpret_cast<const float*>(Bs4);
  int ji = 0;
  while (ji + 1 < jobs.n && (int)blockIdx.x >= jobs.job[ji + 1].tile0) ++ji;
  const Job& jb = jobs.job[ji];
  const int tile = blockIdx.x - jb.tile0;
  const int i0 = (tile / jb.tiles_n) * WT;
  const int j0 = (tile % jb.tiles_n) * WT;
  const bool bias = jb.bias >= 0 && i0 == 0;
  const int n_begin = blockIdx.y * rows_per_slice;
  const int n_end = min(N, n_begin + rows_per_slice);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lk = threadIdx.x / 16, lc = (threadIdx.x % 16) * 4;  // this thread's load

  float acc[4][4];
  zero(acc);
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = n_begin; n0 < n_end; n0 += WK) {
    const int n = n0 + lk;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vb = va;
    if (n < n_end) {
      const int t = n % L;
      if (i0 + lc < jb.a_cols && t >= jb.a_shift)
        va = load_cols4(jb.a0, jb.a1, jb.a_split, jb.a_cols, (size_t)(n - jb.a_shift), i0 + lc);
      if (j0 + lc < jb.b_cols)
        vb = load_cols4(jb.b0, jb.b1, jb.b_split, jb.b_cols, (size_t)n, j0 + lc);
    }
    As4[lk * (WT / 4) + lc / 4] = va;
    Bs4[lk * (WT / 4) + lc / 4] = vb;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * WT + ty * 4);
      const float4 u = *reinterpret_cast<const float4*>(Bs + k * WT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], uv[j], acc[i][j]);
      if (bias && ty == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += uv[j];
      }
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.y * W;
  const int col = j0 + tx * 4;
  if (col >= jb.b_cols) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r < jb.a_cols)
      *reinterpret_cast<float4*>(dst + jb.out + (size_t)r * jb.b_cols + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (bias && ty == 0)
    *reinterpret_cast<float4*>(dst + jb.bias + col) =
        make_float4(bsum[0], bsum[1], bsum[2], bsum[3]);
}

// ---- (d) add the slices' partial sums, in slice order ----------------------
__global__ void bwd_slice_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int W) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < W; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < NSLICE; ++k) s += part[(size_t)k * W + e];
    out[e] = s;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Scratch: dg (B, L, 2C), act (B, L, C), part (NSLICE, W) floats, where W is
// the size of the gradient layout grads = [dWg (K, C_in, 2C) | dbg (2C) |
// dWo (C, 2C) | dbo (2C) | dWr (C_in, C) | dbr (C)].
extern "C" int wst_fused_block_bwd_slices() { return NSLICE; }

extern "C" int wst_fused_gated_block_bwd_f32(
    const float* x, const float* dresid, const float* dskip, const float* gate_w,
    const float* gate_b, const float* woT, const float* wgT, const float* wrT, float* dx,
    float* grads, float* dg, float* act, float* part, int B, int L, int C_in, int C, int K,
    int dilation, void* stream) {
  if (C_in % 4 || C % 4 || K < 1 || K > MAX_TAPS || dilation < 1 || B < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C2 = 2 * C;
  const int N = B * L;
  const int o_dbg = K * C_in * C2;
  const int o_dwo = o_dbg + C2;
  const int o_dbo = o_dwo + C * C2;
  const int o_dwr = o_dbo + C2;
  const int o_dbr = o_dwr + C_in * C;
  const int W = o_dbr + C;
  if (N > 0) {
    const size_t smem = sizeof(float) * (KC * AS + KC * BS);
    const dim3 grid(cdiv(L, TL), B);
    bwd_gate_kernel<<<grid, NT, smem, st>>>(x, gate_w, gate_b, woT, dresid, dskip, dg, act, L,
                                             C_in, C, K, dilation);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    bwd_dx_kernel<<<grid, NT, smem, st>>>(dg, dresid, wgT, wrT, dx, L, C_in, C, K, dilation);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  Jobs jobs;
  int tiles = 0;
  auto add = [&](const float* a0, const float* a1, int a_split, int a_cols, int a_shift,
                 const float* b0, const float* b1, int b_split, int b_cols, int out, int bias) {
    Job& j = jobs.job[jobs.n++];
    j = Job{a0, a1, b0, b1, a_split, a_cols, a_shift, b_split, b_cols, out, bias,
            cdiv(b_cols, WT), tiles};
    tiles += cdiv(a_cols, WT) * j.tiles_n;
  };
  jobs.n = 0;
  for (int tap = 0; tap < K; ++tap)
    add(x, x, C_in, C_in, (K - 1 - tap) * dilation, dg, dg, C2, C2, tap * C_in * C2,
        tap == 0 ? o_dbg : -1);
  add(act, act, C, C, 0, dresid, dskip, C, C2, o_dwo, o_dbo);
  add(x, x, C_in, C_in, 0, dresid, dresid, C, C, o_dwr, o_dbr);
  const int rows = cdiv(N > 0 ? N : 1, NSLICE);
  bwd_wgrad_kernel<<<dim3(tiles, NSLICE), WNT, 0, st>>>(jobs, part, W, N, L > 0 ? L : 1, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_slice_sum_kernel<<<cdiv(W, 256), 256, 0, st>>>(part, grads, W);
  return (int)cudaGetLastError();
}
