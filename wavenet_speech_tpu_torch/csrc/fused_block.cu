// Fused causal gated residual block, forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel wavenet_speech_tpu/ops/pallas/residual_block.py
// (_kernel, launched by _forward). Per (batch b, time tile of TL rows):
//
//   g     = sum_tap x[t - (K-1-tap)*d] @ gate_w[tap] + gate_b     (TL, 2C)
//   act   = tanh(g[:, :C]) * sigmoid(g[:, C:])                     (TL, C)
//   resid = (act @ out_w[:, :C] + out_b[:C]) + x @ res_w + res_b
//   skip  =  act @ out_w[:, C:] + out_b[C:]
//
// What bounds it on an H100: at the serving path's shape (B=8, L=4608,
// C_in=C=256, K=2) a block is 2*B*L*(K*C_in*2C + C*2C + C_in*C) = 33.8 GFLOP
// against ~115 MB of x, outputs and weights, so it is bound by operations
// (float32 on the CUDA cores: 67 TFLOP/s at 700 W, 0.50 ms), not by bytes
// (0.03 ms at 3.35 TB/s).
//
// What the design does about it:
//  * The gate (TL, 2C) and act (TL, C) never reach device memory: the gate is
//    computed one CH-channel chunk at a time (its tanh half and the matching
//    sigmoid half together), the nonlinearity is applied in registers, and
//    act is kept, transposed, in shared memory for the 1x1 products.
//  * The TPU kernel DMAs one contiguous (TL + halo, C_in) window; at d=512
//    that is over 500 KB, more than a block's 227 KB. Here each tap reads its
//    own TL rows of x, rows before 0 read as zero (causal padding), so the
//    shared memory used does not depend on the dilation.
//  * Weights (1.84 MB per block at C=256) are streamed from L2 in chunks of
//    KC=16 rows; each thread computes a 4-row x (4+4)-channel register tile,
//    three 16-byte shared loads per 32 FMAs.
//  * TL = 32 rows a block: 8 row groups x 32 channel groups of threads, CH =
//    128 channels a chunk; 1152 blocks at the serving shape, 55 KB of shared
//    memory, two blocks an SM (125 registers a thread). Of 16, 32 and 64 rows,
//    timed on an H100, 32 was the fastest or tied (PERF.md).
// Tensor cores (TF32/bf16 wgmma) are later work; this kernel keeps float32.
//
// Requires C_in % 4 == 0, C % 4 == 0, contiguous 16-byte-aligned tensors
// (checked by the Python wrapper).

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

size_t smem_bytes(int C) {
  const int Cp = (C + CH - 1) / CH * CH;
  return sizeof(float) * ((size_t)Cp * AS + KC * AS + KC * BS);
}

__global__ void __launch_bounds__(NT, 2)
fused_gated_block_kernel(const float* __restrict__ x, const float* __restrict__ gate_w,
                         const float* __restrict__ gate_b, const float* __restrict__ out_w,
                         const float* __restrict__ out_b, const float* __restrict__ res_w,
                         const float* __restrict__ res_b, float* __restrict__ resid,
                         float* __restrict__ skip, int L, int C_in, int C, int K,
                         int dilation) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Cp = (C + CH - 1) / CH * CH;
  float* actT = smem;              // (Cp, AS): act transposed, channel-major
  float* As = actT + Cp * AS;      // (KC, AS): x tile, transposed
  float* Bs = As + KC * AS;        // (KC, BS): weight tile

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TL;
  const int tx = threadIdx.x % CG;
  const int ty = threadIdx.x / CG;
  const float* xb = x + (size_t)b * L * C_in;
  const int C2 = 2 * C;

  float acc0[4][4], acc1[4][4], acc2[4][4];

  // ---- gate conv + gated activation, one chunk of CH channel pairs at a time
  for (int p0 = 0; p0 < Cp; p0 += CH) {
    zero(acc0);
    zero(acc1);
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx * 4 + j;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (col < C) {
        const float bt = gate_b[col];
        const float bs = gate_b[C + col];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = tanhf(acc0[i][j] + bt) * sigmoid_f(acc1[i][j] + bs);
      }
      *reinterpret_cast<float4*>(actT + col * AS + ty * 4) = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
  __syncthreads();

  // ---- residual|skip 1x1 and the residual projection, CH output channels at a time
  for (int q0 = 0; q0 < C; q0 += CH) {
    zero(acc0);  // act @ out_w[:, q0:q0+CH]          (residual half)
    zero(acc1);  // act @ out_w[:, C+q0:C+q0+CH]      (skip half)
    zero(acc2);  // x @ res_w[:, q0:q0+CH]
    for (int k0 = 0; k0 < C; k0 += KC) {
      load_w_tile<true>(Bs, out_w, C2, k0, C, q0, C + q0, C - q0, C - q0);
      __syncthreads();
      tile_fma<true>(acc0, acc1, actT + k0 * AS, Bs, tx, ty);
      __syncthreads();
    }
    for (int c0 = 0; c0 < C_in; c0 += KC) {
      load_rows_t(As, xb, xb, C_in, t0, c0, L, C_in);
      load_w_tile<false>(Bs, res_w, C, c0, C_in, q0, 0, C - q0, 0);
      __syncthreads();
      tile_fma<false>(acc2, acc2, As, Bs, tx, ty);
      __syncthreads();
    }
    const int col = q0 + tx * 4;
    if (col < C) {
      const float4 ob_r = *reinterpret_cast<const float4*>(out_b + col);
      const float4 ob_s = *reinterpret_cast<const float4*>(out_b + C + col);
      const float4 rb = *reinterpret_cast<const float4*>(res_b + col);
      const float obr[4] = {ob_r.x, ob_r.y, ob_r.z, ob_r.w};
      const float obs[4] = {ob_s.x, ob_s.y, ob_s.z, ob_s.w};
      const float rbv[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t >= L) continue;
        float r[4], s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r[j] = ((acc0[i][j] + obr[j]) + acc2[i][j]) + rbv[j];
          s[j] = acc1[i][j] + obs[j];
        }
        const size_t off = ((size_t)b * L + t) * C + col;
        *reinterpret_cast<float4*>(resid + off) = make_float4(r[0], r[1], r[2], r[3]);
        *reinterpret_cast<float4*>(skip + off) = make_float4(s[0], s[1], s[2], s[3]);
      }
    }
  }
}

}  // namespace

extern "C" int wst_fused_gated_block_f32(const float* x, const float* gate_w,
                                         const float* gate_b, const float* out_w,
                                         const float* out_b, const float* res_w,
                                         const float* res_b, float* resid, float* skip,
                                         int B, int L, int C_in, int C, int K,
                                         int dilation, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (C_in % 4 || C % 4 || K < 1 || dilation < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  int rc = wst_set_smem(fused_gated_block_kernel, smem);
  if (rc) return rc;
  dim3 grid((L + TL - 1) / TL, B);
  fused_gated_block_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, gate_w, gate_b, out_w, out_b, res_w, res_b, resid, skip, L, C_in, C, K, dilation);
  return (int)cudaGetLastError();
}
