// Fused gated residual block, causal or centred, forward, bf16, on Hopper's
// tensor cores (sm_90a).
//
// Replaces the bf16 form of the Pallas TPU kernel wavenet_speech_tpu/ops/
// pallas/residual_block.py (_kernel, :58-94, launched by _forward), which is
// causal only. Per (batch b, tile of TM time rows), with the tap origin R (0
// for a causal block, the right pad for a centred one; fused_block.cu):
//
//   g     = sum_tap x[t - (K-1-tap)*d + R] @ gate_w[tap] + gate_b  (TM, 2C)
//   act   = bf16(tanh(g[:, :C]) * sigmoid(g[:, C:]))               (TM, C)
//   resid = bf16(act @ out_w[:, :C] + x @ res_w + out_b[:C] + res_b)
//   skip  = bf16(act @ out_w[:, C:] + out_b[C:])
//
// Every product multiplies two bf16 values (act is rounded before the 1x1,
// as the TPU kernel's act.astype at :88), so bf16 wgmma with float32
// accumulators computes the products of the TPU kernel's MXU exactly; only
// the order of the float32 sums differs.
//
// What bounds it on an H100: at the bench shape (B=8, L=4505, C_in=C=256,
// K=2) the call is 33.1 GFLOP of bf16 products against 56 MB of bf16
// tensors: 0.034 ms at the tensor cores' 989 TFLOP/s, 0.017 ms at 3.35 TB/s,
// so operations bound it.
//
// The design:
//  * TM = 64 rows a block, one warpgroup issuing wgmma.mma_async m64n128k16
//    (bf16 x bf16 -> float32) on 128-byte-swizzled shared-memory tiles
//    (wgmma.cuh) that cp.async fills: a ring of two (A, B) slots 64 deep in
//    K (ring_loop), loaded one step ahead; 113 KB of shared memory at
//    C = 256, so two blocks share an SM and each one's loads overlap the
//    other's products. 576 blocks at the bench shape. On the H100 this ran
//    faster than 128 rows a block (two warpgroups, three slots, one block an
//    SM).
//  * Gate: 128 channel pairs a chunk. One B tile holds gate_w^T's tanh rows
//    [p0, p0+128) and sigmoid rows [C+p0, ...) (the wrapper passes gate_w
//    K-major), two m64n128 products fill a tanh and a sigmoid accumulator
//    whose registers pair up element by element; the epilogue writes bf16
//    act into shared memory, where it stays as the A operand of the 1x1.
//  * Padding: each tap's x rows are copied with cp.async's zero fill for
//    rows before 0 and from L on, within the sequence, so any dilation and
//    origin work without a halo buffer and the shared memory used does not
//    depend on them.
//  * 1x1: per 128 output channels, out_w^T's residual and skip rows as one
//    B tile over act, then x @ res_w^T into the residual accumulator; float
//    epilogue, staged through shared memory so that resid and skip leave as
//    whole 16-byte pieces, masked at the ragged last tile.
//  * Weights (0.9 MB a block at C = 256) come from L2 through the ring.
//
// Requires C_in % 8 == 0 and C % 8 == 0 (the wrapper zero-pads other
// widths), contiguous bf16 tensors aligned to 16 bytes: x (B, L, C_in),
// gate_w^T (K, 2C, C_in), gate_b (2C), out_w^T (2C, C), out_b (2C),
// res_w^T (C, C_in), res_b (C); resid and skip (B, L, C).

#include <cuda_runtime.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NT = 128;                   // one warpgroup: wgmma's 64 rows are TM
constexpr int TM = 64;                    // time rows a block
constexpr int STAGES = 2;                 // ring slots: two blocks an SM at C = 256
constexpr int A_BYTES = TM * ROW_BYTES;   // (TM, 64) tile
constexpr int B_BYTES = 256 * ROW_BYTES;  // (256, 64) tile
constexpr int SLOT = A_BYTES + B_BYTES;
constexpr int HALF = 128 * ROW_BYTES;     // a 128-row half of the B tile

struct Args {
  const bf16 *x, *wgT, *gate_b, *woT, *out_b, *wrT, *res_b;
  bf16 *resid, *skip;
  int L, C_in, C, K, dilation, origin;
};

size_t smem_bytes(int C) {
  return 1024 + (size_t)STAGES * SLOT + (size_t)((C + TK - 1) / TK) * A_BYTES;
}

// The block's steps, each one ring slot: nc * K * nki gate steps (chunk p of
// 128 channel pairs, tap, K chunk kc), then per chunk q of 128 output
// channels na steps over act and nki over x.
struct Step {
  bool gate, act;  // gate step; else a 1x1 step over act (act) or x (res_w)
  int chunk, tap, kc;
  bool first, last;  // of its output chunk
};

__device__ __forceinline__ Step decode(int s, int nc, int na, int nki, int K) {
  const int G = nc * K * nki;
  if (s < G) {
    const int per = K * nki, rem = s % per;
    return Step{true, false, s / per, rem / nki, rem % nki, rem == 0, rem == per - 1};
  }
  const int per = na + nki, u = (s - G) % per;
  return Step{false, u < na, (s - G) / per, 0, u < na ? u : u - na, u == 0, u == per - 1};
}

__global__ void __launch_bounds__(NT, 2) fused_gated_block_bf16_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw);
  const uint32_t act = ring + STAGES * SLOT;  // na tiles of (TM, 64)
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int C = a.C, C_in = a.C_in;
  const int nc = (C + 127) / 128, na = (C + TK - 1) / TK, nki = (C_in + TK - 1) / TK;
  const bf16* xb = a.x + (size_t)b * a.L * C_in;
  float acc[2][64];  // gate: tanh, sigmoid halves; 1x1: resid, skip

  auto load = [&](int s, uint32_t slot) {
    const Step st = decode(s, nc, na, nki, a.K);
    const uint32_t sb = slot + A_BYTES;
    const int c0 = st.kc * TK, r0 = st.chunk * 128;
    if (st.gate) {
      const bf16* w = a.wgT + (size_t)st.tap * 2 * C * C_in;
      const bf16* ws = w + (size_t)C * C_in;
      load_rows<NT>(slot, TM, xb, xb, C_in, C_in, t0 - (a.K - 1 - st.tap) * a.dilation + a.origin,
                    a.L, c0);
      load_rows<NT>(sb, 128, w, w, C_in, C_in, r0, C, c0);
      load_rows<NT>(sb + HALF, 128, ws, ws, C_in, C_in, r0, C, c0);
    } else if (st.act) {
      const bf16* ws = a.woT + (size_t)C * C;
      load_rows<NT>(sb, 128, a.woT, a.woT, C, C, r0, C, c0);
      load_rows<NT>(sb + HALF, 128, ws, ws, C, C, r0, C, c0);
    } else {
      load_rows<NT>(slot, TM, xb, xb, C_in, C_in, t0, a.L, c0);
      load_rows<NT>(sb, 128, a.wrT, a.wrT, C_in, C_in, r0, C, c0);
    }
  };
  auto mma = [&](int s, uint32_t slot) {
    const Step st = decode(s, nc, na, nki, a.K);
    if (st.first) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    }
    wg_fence();
    const uint32_t A = st.act ? act + st.kc * A_BYTES : slot;
    const uint32_t Bt = slot + A_BYTES;
#pragma unroll
    for (int k = 0; k < TK / 16; ++k) {
      mma_n128(acc[0], desc_b128(A + 32 * k), desc_b128(Bt + 32 * k));
      if (st.gate || st.act) mma_n128(acc[1], desc_b128(A + 32 * k), desc_b128(Bt + HALF + 32 * k));
    }
  };
  auto last = [&](int s) { return decode(s, nc, na, nki, a.K).last; };
  auto epilogue = [&](int s) {
    const Step st = decode(s, nc, na, nki, a.K);
    fence_regs<64>(acc[0]);
    fence_regs<64>(acc[1]);
    if (st.gate) {  // act = bf16(tanh * sigmoid) of channels 128 p + [0, 128), into shared memory
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int c = acc_col(i), ch = st.chunk * 128 + c;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = ch + e < C ? tanhf(acc[0][i + e] + ld_f(a.gate_b + ch + e)) *
                                  sigmoid_f(acc[1][i + e] + ld_f(a.gate_b + C + ch + e))
                            : 0.f;
        if (ch < na * TK)
          st_shared_u32(act + (ch / TK) * A_BYTES + swz(acc_row(i), c % TK),
                        pack2(v[0], v[1]));
      }
    } else {  // resid and skip of output channels 128 q + [0, 128), staged
      __syncthreads();  // every warpgroup is past its products on the slot staged in
      const int warp = threadIdx.x >> 5, row0 = t0 + 16 * warp;
      const int ch0 = st.chunk * 128;
      uint8_t* stg = smem_ptr(smem_raw, ring + (s % STAGES) * SLOT) + warp * 4096;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int ch = ch0 + acc_col(i);
          float v[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2 && ch < C; ++e)
            v[e] = h ? acc[1][i + e] + ld_f(a.out_b + C + ch + e)
                     : (acc[0][i + e] + ld_f(a.out_b + ch + e)) + ld_f(a.res_b + ch + e);
          *reinterpret_cast<uint32_t*>(stg + stage_off(frag_row(i), 2 * acc_col(i))) = pack2(v[0], v[1]);
        }
        stage_flush(stg, reinterpret_cast<uint8_t*>((h ? a.skip : a.resid) + ((size_t)b * a.L + row0) * C + ch0),
                    2 * (size_t)C, min(16, a.L - row0), 2 * min(128, C - ch0));
      }
    }
  };
  ring_loop<STAGES, SLOT>(ring, nc * a.K * nki + nc * (na + nki), load, mma, last, epilogue);
}

}  // namespace

extern "C" int wst_fused_gated_block_bf16(const bf16* x, const bf16* wgT, const bf16* gate_b,
                                          const bf16* woT, const bf16* out_b, const bf16* wrT,
                                          const bf16* res_b, bf16* resid, bf16* skip, int B,
                                          int L, int C_in, int C, int K, int dilation, int origin,
                                          void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (C_in % 8 || C % 8 || C_in <= 0 || C <= 0 || K < 1 || dilation < 1 || origin < 0 ||
      origin > (K - 1) * dilation)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);  // C <= 1152: act and the ring fit a block's 227 KB
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  int rc = wst_set_smem(fused_gated_block_bf16_kernel, smem);
  if (rc) return rc;
  const Args a{x, wgT, gate_b, woT, out_b, wrT, res_b, resid, skip, L, C_in, C, K, dilation,
               origin};
  fused_gated_block_bf16_kernel<<<dim3((L + TM - 1) / TM, B), NT, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
