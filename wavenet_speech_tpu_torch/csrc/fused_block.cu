// Fused gated residual block, causal or centred, forward, float32, on
// Hopper's tensor cores (sm_90a). The bf16 form is fused_block_bf16.cu.
//
// Replaces the Pallas TPU kernel wavenet_speech_tpu/ops/pallas/residual_block.py
// (_kernel, :58, launched by _forward), which is causal only, and the XLA
// composite of the centred (non-causal) block. Per (batch b, tile of TM time
// rows), with the tap origin R (0 for a causal block; for a centred one the
// right pad (K-1)*d - autopad(K, d) of ops/conv.py):
//
//   g     = sum_tap x[t - (K-1-tap)*d + R] @ gate_w[tap] + gate_b  (TM, 2C)
//   act   = tanh(g[:, :C]) * sigmoid(g[:, C:])                     (TM, C)
//   resid = (act @ out_w[:, :C] + x @ res_w + out_b[:C]) + res_b
//   skip  =  act @ out_w[:, C:] + out_b[C:]
//
// What bounds it on an H100: at the serving path's shape (B=8, L=4608,
// C_in=C=256, K=2) a call is 2*B*L*(K*C_in*2C + C*2C + C_in*C) = 33.8 GFLOP
// against ~115 MB of x, outputs and weights (0.03 ms at 3.35 TB/s), so
// operations bound it: 0.50 ms on the CUDA cores at 67 TFLOP/s, 0.205 ms as
// float32-accurate split products on the tensor cores (3 TF32 products each,
// 495 TFLOP/s). Every product here is such a split product (tma_tf32.cuh),
// within a few units of float32's rounding; no product takes a single TF32
// pass.
//
// What the design does about it:
//  * A block is two consumer warpgroups (TM = 128 rows; one, TM = 64, when
//    C > 256) and one producer warpgroup, one thread of which keeps TMA
//    copies in flight into a ring of STAGES mbarrier-guarded slots (the
//    producer gives its registers to the consumers with setmaxnreg). The
//    consumers load their A fragments from the slot, split them in
//    registers and issue three TF32 wgmma a k8 step against the weights' hi
//    and lo planes, with no block barrier a step; the two warpgroups take
//    turns to issue (Turns), so one's adds and loads overlap the other's
//    products. The call first splits the weights into K-major hi and lo
//    planes (split_planes): gate_w^T, out_w^T, res_w^T.
//  * Padding: x is read through a 3-D map over (C_in, L, B), each tap its
//    own TM rows at t0 - s_tap + R; rows before 0 and from L on arrive as
//    zeros, TMA's out-of-bounds fill, never as the previous read's rows. The
//    TPU kernel DMAs one (TM + halo) window; at d = 512 that is over 500 KB,
//    more than a block's 227 KB, so the shared memory used here does not
//    depend on the dilation. A tap whose rows all lie outside [0, L) is
//    skipped; the residual 1x1 reads x unshifted.
//  * Gate: NP = 64 channel pairs a chunk; one step's B is the tanh rows and
//    the sigmoid rows of gate_w^T (hi and lo each), two m64n64 products whose
//    accumulators pair up element by element. The epilogue writes act,
//    float32, into shared memory (TM x C, 32-column swizzled tiles), where
//    each warpgroup reads its own 64 rows back as the A operand of the 1x1.
//  * 1x1: NO = 64 output channels a chunk: out_w^T's residual and skip rows
//    over act (two m64n64), then res_w^T over x into the residual
//    accumulators; the biases are added in the epilogue, masked at the
//    ragged last tile.
//  * Above C = 512 act does not fit: the gate writes it to device memory
//    (act scratch) and a second launch reads it back through TMA like x.
//  * Shared memory at C = 256: act's 128 KB and two 48 KB slots, 225 KB,
//    one block an SM (288 blocks at the serving shape). act leaves no room
//    for a third slot; of NP = 32 with three 32 KB slots and NP = 64 with
//    two 48 KB slots, timed on the H100, the second was faster: it reads
//    x's rows for the gate half as often from L2.
// Requires C_in % 32 == 0, C % 32 == 0 (the wrapper zero-pads other
// widths), contiguous float tensors aligned to 16
// bytes: x (B, L, C_in), gate_w (K, C_in, 2C), gate_b (2C), out_w (C, 2C),
// out_b (2C), res_w (C_in, C), res_b (C); resid and skip (B, L, C); planes,
// scratch of 2 (K 2C C_in + 2C C + C C_in) floats; act, (B, L, C) floats
// when C > 512, else unused.

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "tma_tf32.cuh"

namespace {

constexpr int NP = 64;  // gate channel pairs a chunk
constexpr int NO = 64;  // 1x1 output channels a chunk
constexpr int MAX_C = 512;  // the widest act kept in shared memory (TM = 64)

// WIDE (C > MAX_C): two launches, the gate writing act to device memory and
// the 1x1 reading it back through TMA like x, with a deeper ring.
template <bool WIDE>
__host__ __device__ constexpr int stages() {
  return WIDE ? 4 : 2;
}
// A ring slot: the largest step, a gate step (x rows; tanh and sigmoid
// rows, hi and lo) or a 1x1 step over act (act rows if WIDE; residual and
// skip rows, hi and lo)
template <int NWG, bool WIDE>
__host__ __device__ constexpr int slot_bytes() {
  return WIDE || 64 * NWG * ROW_BYTES + 4 * NP * ROW_BYTES > 4 * NO * ROW_BYTES
             ? 64 * NWG * ROW_BYTES + 4 * (NP > NO ? NP : NO) * ROW_BYTES
             : 4 * NO * ROW_BYTES;
}

struct FwdParams {
  CUtensorMap x;   // (C_in, L, B), boxes of TM rows
  CUtensorMap wg;  // gate_w^T planes: K matrices, halves tanh | sigmoid, boxes of NP rows
  CUtensorMap wo;  // out_w^T planes: halves residual | skip, boxes of NO rows
  CUtensorMap wr;  // res_w^T planes, boxes of NO rows
  CUtensorMap act;  // WIDE: act (C, L, B) in device memory, boxes of TM rows
  const float *gate_b, *out_b, *res_b;
  float *resid, *skip, *act_out;
  int L, C_in, C, K, dilation, origin;
  int phase;  // WIDE: 0 the gate, 1 the 1x1
};

template <int NWG, bool WIDE>
constexpr size_t smem_bytes(int C) {
  return 1024 + (size_t)stages<WIDE>() * slot_bytes<NWG, WIDE>() +
         (WIDE ? 0 : (size_t)64 * NWG * C * 4) + 16 * stages<WIDE>();
}

// The block's steps, each one ring slot: C / NP gate chunks of K * nki steps
// (tap, 32-column slot of x), then per 1x1 chunk na steps over act and nki
// over x.
struct Step {
  int kind;  // 0 gate, 1 act, 2 x
  int chunk, tap, kc;
  bool first, last;  // of its output chunk
};

__device__ __forceinline__ Step decode(int s, int nc, int na, int nki, int K) {
  const int G = nc * K * nki;
  if (s < G) {
    const int per = K * nki, u = s % per;
    return Step{0, s / per, u / nki, u % nki, u == 0, u == per - 1};
  }
  const int per = na + nki, u = (s - G) % per;
  return Step{u < na ? 1 : 2, (s - G) / per, 0, u < na ? u : u - na, u == 0, u == per - 1};
}

// (launch bounds of three warpgroups for both: the registers a thread starts
// with are then at most 168, below what setmaxnreg raises the consumers to)
template <int NWG, bool WIDE>
__global__ void __launch_bounds__(384, 1)
    fused_gated_block_kernel(const __grid_constant__ FwdParams p) {
  constexpr int TM = 64 * NWG, A_BYTES = TM * ROW_BYTES, PLANE = NO * ROW_BYTES;
  constexpr int STAGES = stages<WIDE>(), SLOT = slot_bytes<NWG, WIDE>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = smem_base(smem_raw), act = ring + STAGES * SLOT;  // act: C / 32 tiles
  const Ring<STAGES> rg{act + (WIDE ? 0u : (uint32_t)(TM * p.C * 4))};
  const int b = blockIdx.y, t0 = blockIdx.x * TM, K = p.K;
  const int nc = cdiv(p.C, NP), na = p.C / KS, nki = p.C_in / KS, no = cdiv(p.C, NO);
  const int G = nc * K * nki;  // the gate's steps; the 1x1's follow
  const int s0 = WIDE && p.phase == 1 ? G : 0;
  const int S = WIDE && p.phase == 0 ? G : G + no * (na + nki);
  // the first row of x a gate step of tap `tap` reads; a step whose TM rows
  // all lie outside [0, L) adds nothing
  auto tap_row = [&](int tap) { return t0 - (K - 1 - tap) * p.dilation + p.origin; };
  auto skip = [&](const Step& st) {
    return st.kind == 0 && (tap_row(st.tap) + TM <= 0 || tap_row(st.tap) >= p.L);
  };
  if (threadIdx.x == 0) rg.init(4 * NWG);
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {  // the producer warpgroup: one thread issues every copy
    producer_regs();
    if (threadIdx.x == 128 * NWG) {
      for (int s = s0, n = 0; s < S; ++s) {
        const Step st = decode(s, nc, na, nki, K);
        if (skip(st)) continue;
        const uint32_t slot = ring + (n % STAGES) * SLOT, bar = rg.full(n), c = st.kc * KS;
        if (st.kind == 0) {  // x rows of the tap; tanh rows, sigmoid rows (hi, lo each)
          rg.produce(n++, A_BYTES + 4 * NP * ROW_BYTES);
          tma_load(slot, &p.x, bar, c, tap_row(st.tap), b);
          for (int h = 0; h < 2; ++h)
            for (int pl = 0; pl < 2; ++pl)
              tma_load(slot + A_BYTES + (2 * h + pl) * NP * ROW_BYTES, &p.wg, bar, c, st.chunk * NP,
                       h, pl * K + st.tap);
        } else if (st.kind == 1) {  // (act rows;) residual rows, skip rows of out_w^T (hi, lo each)
          const uint32_t B0 = WIDE ? slot + A_BYTES : slot;
          rg.produce(n++, (WIDE ? A_BYTES : 0) + 4 * PLANE);
          if (WIDE) tma_load(slot, &p.act, bar, c, t0, b);
          for (int h = 0; h < 2; ++h)
            for (int pl = 0; pl < 2; ++pl)
              tma_load(B0 + (2 * h + pl) * PLANE, &p.wo, bar, c, st.chunk * NO, h, pl);
        } else {  // x rows; res_w^T rows (hi, lo)
          rg.produce(n++, A_BYTES + 2 * PLANE);
          tma_load(slot, &p.x, bar, c, t0, b);
          for (int pl = 0; pl < 2; ++pl)
            tma_load(slot + A_BYTES + pl * PLANE, &p.wr, bar, c, st.chunk * NO, 0, pl);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x >> 7;
  int n = 0;  // ring steps consumed
  Turns<NWG> turns;
  // One step: its A fragments (this warpgroup's 64 rows of x in the slot, or
  // of act), then products(f, slot) into a step's sum (mma_step), waited for.
  auto step = [&](const Step& st, auto products) {
    const uint32_t slot = ring + (n % STAGES) * SLOT;
    const uint32_t A = (st.kind == 1 && !WIDE ? act + st.kc * A_BYTES : slot) + wg * 64 * ROW_BYTES;
    rg.wait_full(n);
    Frag f[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) f[kk] = load_frag([&](int r, int c) { return A + swz32(r, c); }, kk);
    turns.wait();
    wg_fence();
    products(f, slot);
    wg_commit();
    turns.pass();
    wg_wait<0>();
    rg.release(n++);
  };


  {  // the gate, NP channel pairs a chunk: tanh [0, NP / 2), sigmoid [NP / 2, NP)
    float acc[NP], sa[NP];  // the chunk's sums, a step's
#pragma unroll
    for (int i = 0; i < NP; ++i) sa[i] = 0.f;
    for (int s = s0; s < min(S, G); ++s) {
      const Step st = decode(s, nc, na, nki, K);
      if (st.first) {
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] = 0.f;
      }
      if (!skip(st)) {
        step(st, [&](const Frag* f, uint32_t slot) {
          const uint32_t B0 = slot + A_BYTES;
          mma_step<NP>(sa, f, B0, B0 + NP * ROW_BYTES);
          mma_step<NP>(sa + NP / 2, f, B0 + 2 * NP * ROW_BYTES, B0 + 3 * NP * ROW_BYTES);
        });
        add_step<NP>(acc, sa);
      }
      // (a centred block's last tap may be skipped: act is written all the same)
      if (!st.last) continue;
      // act of channels NP chunk + [0, NP), into act's 32-column tiles
#pragma unroll
      for (int i = 0; i < NP / 2; i += 2) {
        const int r = 64 * wg + acc_row(i), ch = st.chunk * NP + acc_col(i);
        if (ch >= p.C) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = tanhf(acc[i + e] + p.gate_b[ch + e]) *
                 sigmoid_f(acc[NP / 2 + i + e] + p.gate_b[p.C + ch + e]);
        if (!WIDE)
          st_shared_f32x2(act + (ch / KS) * A_BYTES + swz32(r, ch % KS), v[0], v[1]);
        else if (t0 + r < p.L)
          *reinterpret_cast<float2*>(p.act_out + ((size_t)b * p.L + t0 + r) * p.C + ch) =
              make_float2(v[0], v[1]);
      }
    }
  }
  if (!WIDE) bar_sync(1 + wg, 128);  // this warpgroup's act rows are all written

  {  // the 1x1, NO output channels a chunk: residual [0, 32), skip [32, 64) (m64n64 each)
    float acc[64], sa[64];  // the chunk's sums, a step's
#pragma unroll
    for (int i = 0; i < 64; ++i) sa[i] = 0.f;
    for (int s = max(s0, G); s < S; ++s) {
      const Step st = decode(s, nc, na, nki, K);
      if (st.first) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      step(st, [&](const Frag* f, uint32_t slot) {
        if (st.kind == 1) {  // over act
          const uint32_t B0 = WIDE ? slot + A_BYTES : slot;
          mma_step<64>(sa, f, B0, B0 + PLANE);
          mma_step<64>(sa + 32, f, B0 + 2 * PLANE, B0 + 3 * PLANE);
        } else {  // over x, into the residual half only
          mma_step<64>(sa, f, slot + A_BYTES, slot + A_BYTES + PLANE);
        }
      });
      if (st.kind == 1)
        add_step<64>(acc, sa);
      else
        add_step<32>(acc, sa);
      if (!st.last) continue;
      // resid and skip of output channels NO chunk + [0, NO)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int t = t0 + 64 * wg + acc_row(i), ch = st.chunk * NO + acc_col(i);
        if (t >= p.L || ch >= p.C) continue;
        const size_t off = ((size_t)b * p.L + t) * p.C + ch;
        float r[2], k[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          r[e] = (acc[i + e] + p.out_b[ch + e]) + p.res_b[ch + e];
          k[e] = acc[32 + i + e] + p.out_b[p.C + ch + e];
        }
        *reinterpret_cast<float2*>(p.resid + off) = make_float2(r[0], r[1]);
        *reinterpret_cast<float2*>(p.skip + off) = make_float2(k[0], k[1]);
      }
    }
  }
  turns.finish();
}

template <int NWG, bool WIDE>
int launch(const FwdParams& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes<NWG, WIDE>(a.C);
  int rc = wst_set_smem(fused_gated_block_kernel<NWG, WIDE>, smem);
  if (rc) return rc;
  fused_gated_block_kernel<NWG, WIDE><<<dim3(cdiv(a.L, 64 * NWG), B), 128 * NWG + 128, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Above this C the call needs act, scratch of B L C floats.
extern "C" int wst_fused_block_max_channels() { return MAX_C; }

extern "C" int wst_fused_gated_block_f32(const float* x, const float* gate_w, const float* gate_b,
                                         const float* out_w, const float* out_b, const float* res_w,
                                         const float* res_b, float* resid, float* skip,
                                         float* planes, float* act, int B, int L, int C_in, int C,
                                         int K, int dilation, int origin, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (C_in % 32 || C % 32 || C_in <= 0 || C <= 0 || K < 1 || dilation < 1 || origin < 0 ||
      origin > (K - 1) * dilation || (C > MAX_C && !act))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the weights' hi and lo planes, K-major: gate_w^T, out_w^T, res_w^T
  float* wg_p = planes;
  float* wo_p = wg_p + split_planes(gate_w, wg_p, K, C_in, 2 * C, true, st);
  float* wr_p = wo_p + split_planes(out_w, wo_p, 1, C, 2 * C, true, st);
  split_planes(res_w, wr_p, 1, C_in, C, true, st);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // act (64 NWG x C floats) and the ring fit 227 KB; wider, act goes through act
  const int NWG = C <= 256 || C > MAX_C ? 2 : 1;
  FwdParams a{};
  if ((rc = map_rows(&a.x, x, B, L, C_in, 64 * NWG)) ||
      (rc = map_weights(&a.wg, wg_p, K, 2, C, C_in, NP)) ||
      (rc = map_weights(&a.wo, wo_p, 1, 2, C, C, NO)) ||
      (rc = map_weights(&a.wr, wr_p, 1, 1, C, C_in, NO)))
    return rc;
  a.gate_b = gate_b, a.out_b = out_b, a.res_b = res_b, a.resid = resid, a.skip = skip;
  a.L = L, a.C_in = C_in, a.C = C, a.K = K, a.dilation = dilation, a.origin = origin;
  if (C <= MAX_C) return NWG == 2 ? launch<2, false>(a, B, st) : launch<1, false>(a, B, st);
  if ((rc = map_rows(&a.act, act, B, L, C, 128))) return rc;
  a.act_out = act;
  a.phase = 0;
  if ((rc = launch<2, true>(a, B, st))) return rc;
  a.phase = 1;
  return launch<2, true>(a, B, st);
}
