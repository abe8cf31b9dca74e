// CTC alpha (forward) and beta (backward) recursions over extended-label
// log-probs, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of wavenet_speech_tpu/ops/pallas/ctc.py:
//   wst_ctc_alpha_f32  <- _fwd_kernel (:83, B1; pallas_call at :239)
//   wst_ctc_beta_f32   <- _bwd_kernel (:142, B2; pallas_call at :283)
// Given a carry (alpha_in / lpb_in, t_offset, tl_true) the same entry points
// are B3, the segments of the sequence-sharded CTC (ctc.py:335, :355).
//
// Per frame t of sequence b, over the J = 2S+1 lattice states j:
//   alpha_t[j] = lae(lae(alpha[j], alpha[j-1]), alpha[j-2] + skipadd[j]) + lp[t][j]
//   beta_t[j]  = lae(lae(lpb[j], lpb[j+1]), lpb[j+2] + skipadd[j+2])
//   grad[t][j] = exp(alpha_t[j] + beta_t[j] - ll) * cot        (lpb = lp + beta)
// with lae(a, b) = max(a, b) + log1p(exp(-|a - b|)) (jnp.logaddexp's form),
// NEG = -1e30 for -inf, the t = 0 init, the terminal mask at t = len - 1,
// and frames past a sequence's length (or past tl_true, the segment's
// length) carrying the state through. Segments: the state enters through
// alpha_in / lpb_in and leaves through alpha_out / lpb_out, and frame lt is
// global frame t_offset + lt, as in the TPU kernels.
//
// What bounds it on an H100: at the bench shape (T=1126, B=8, J=859) B1
// moves 62 MB and B2 93 MB, 0.02-0.03 ms at 3.35 TB/s, but neither comes
// near that. Each is a chain of T dependent frames; a frame of a state
// needs the previous frame of its two neighbours below (B2: above), so the
// states of a sequence exchange their edges every frame. A state costs two
// lae in a row, each an expf and a log1pf (~35 dependent instructions, and
// a branch inside log1pf that keeps the compiler from interleaving two
// states of one thread): ~400 cycles of latency a frame that no layout
// removes. On one SM a sequence also pays the issue of ~90 instructions a
// state for J states, and the frame's edge exchange and barrier.
//
// What the design does about it:
//  * A sequence on a thread-block cluster of C blocks (C <= 4, chosen by
//    the wrapper so that every block has an SM of its own): block c takes
//    the states [c Jc, (c+1) Jc): C B SMs (32 at the bench shape) where one
//    block a sequence used B. The dependency between blocks runs one way
//    (alpha up, beta down), so blocks pipeline: a block hands its two edge
//    states after every frame to the next block through a ring of XE slots
//    in the receiver's shared memory, written with st.async, whose bytes
//    complete the receiver's mbarrier; the receiver frees a slot with a
//    relaxed remote arrive (a release arrive at cluster scope costs more
//    than a frame). One warp a block carries these hand-offs, off the
//    frames' critical path. The first block runs ahead of the next by up
//    to XE frames, so a hand-off is in place before it is needed.
//  * Lattice runs in registers. Thread i of a block owns the R consecutive
//    states [iR, iR + R) (R = 1 at the bench shape; 2, 4 or 8 for long
//    lattices), so a state's neighbours j-1, j-2 (beta: j+1, j+2) are the
//    thread's own registers or the neighbouring lanes' (__shfl_up/down_sync),
//    and shared memory only at a warp's edge: one block barrier a frame,
//    with the warp edges double buffered by frame parity and each edge
//    state written by the lane that holds it.
//  * A deep asynchronous frame ring. Each thread stages its own run of the
//    next D-1 frames' log-probs (B2: and alphas) in shared memory with
//    4-byte cp.async (rows are J floats at offset b*J, J odd, so only
//    4-byte aligned), one commit group a frame, and waits with
//    cp.async.wait_group for the frame it needs. A thread reads only what
//    it copied itself, so the ring needs no barrier of its own; it loads the
//    next frame's run before the frame's barrier, and the HBM round trip
//    overlaps the D-1 frames before it. D (<= MAX_RING) is the most the
//    shared memory holds, chosen by the wrapper.
//  * The alphas (B1) and the gradient (B2) are written once with streaming
//    stores (__stcs), after the frame's edge is published.
//  * Each state is computed by the same operations as the plain frame loop
//    (ops/ctc_scan.py): alphas, gradients and carries equal it bit for bit;
//    only the final log-likelihood's reduction (over the blocks of the
//    cluster) runs in another order.
// The TPU kernel's time chunking existed only to fit its VMEM and is not
// ported.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
// threads a block of runs of R at most: runs of 8 take at most 4096 states a
// block (J <= 8192 on 2 blocks), which leaves them 113 registers a thread
__host__ __device__ constexpr int max_threads(int R) { return R >= 8 ? 576 : MAX_THREADS; }
constexpr int MAX_RING = 16;     // frames of the frame ring at most
constexpr int MAX_CLUSTER = 4;   // blocks a sequence at most
constexpr int XE = 32;           // frames a block may run ahead of the block it feeds

__device__ __forceinline__ float lae(float a, float b) {
  const float d = a - b;
  // the NaN case selected, not branched to: the same value, one branch
  // fewer in the frame's dependent chain
  const float r = fmaxf(a, b) + log1pf(expf(-fabsf(d)));
  return isnan(d) ? a + b : r;
}

__device__ __forceinline__ float terminal(int j, int lab) {
  return (j == 2 * lab || (j == 2 * lab - 1 && lab > 0)) ? 0.f : NEG;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's commit groups are pending (n < MAX_RING).
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: cp_wait_n<0>(); break;
    case 1: cp_wait_n<1>(); break;
    case 2: cp_wait_n<2>(); break;
    case 3: cp_wait_n<3>(); break;
    case 4: cp_wait_n<4>(); break;
    case 5: cp_wait_n<5>(); break;
    case 6: cp_wait_n<6>(); break;
    case 7: cp_wait_n<7>(); break;
    case 8: cp_wait_n<8>(); break;
    case 9: cp_wait_n<9>(); break;
    case 10: cp_wait_n<10>(); break;
    case 11: cp_wait_n<11>(); break;
    case 12: cp_wait_n<12>(); break;
    case 13: cp_wait_n<13>(); break;
    case 14: cp_wait_n<14>(); break;
    default: cp_wait_n<15>(); break;
  }
}

// ---- the thread-block cluster: one sequence on C blocks -----------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of a shared-memory location of this block in block `rank`.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_remote(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive on a barrier of block `rank` and expect 8 more bytes to complete
// its phase. Relaxed: it orders nothing (the bytes carry the data).
__device__ __forceinline__ void mbar_expect8_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.relaxed.cluster.shared::cluster.b64 _, [%0], 8;\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of this block's barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Store (v0, v1) at addr in another block; its barrier bar counts the 8 bytes.
__device__ __forceinline__ void st_async2(uint32_t addr, float v0, float v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(v0), "f"(v1), "r"(bar)
      : "memory");
}

// The edge a block hands the next block of its cluster after every frame
// (alpha: its two highest states up; beta: its two lowest down), through a
// ring of XE slots in the receiving block. Use k is the state after k
// frames (k = 0: the carry), in slot k % XE, phase k / XE of its barriers.
// The sender arms the receiver's `full` barrier of the slot for 8 bytes and
// stores the two values there asynchronously (st.async), which completes
// it: the values reach the receiver through the barrier's byte count. The
// receiver, having read them, arrives on the sender's `empty` barrier of
// the slot. Both arrives are relaxed: a release arrive at cluster scope
// costs more than a frame, even from the edge warp, which stores nothing
// to global memory. The receiver stores the values it read (into the
// warp edges) before it arrives, so in-order issue has the read complete
// before the sender can learn that the slot is free.
struct ClusterEdge {
  float* vals;       // (XE, 2) this block's receiving slots
  uint64_t* full;    // (XE) this block's: a slot received
  uint64_t* empty;   // (XE) this block's: a slot it sent was read

  // The sender's one thread: wait until slot k is free, send use k to block `to`.
  __device__ __forceinline__ void put(int to, int k, float v0, float v1) const {
    const int s = k & (XE - 1);
    const unsigned n = (unsigned)k / XE;
    if (n > 0) mbar_wait(empty + s, (n - 1) & 1);
    const uint32_t bar = remote(full + s, to);
    mbar_expect8_remote(bar);
    st_async2(remote(vals + 2 * s, to), v0, v1, bar);
  }

  // The receiver's one thread: wait for use k, read it into v0, v1 (shared
  // memory: the warp edges), free the slot in block `from`.
  __device__ __forceinline__ void take(int from, int k, float& v0, float& v1) const {
    const int s = k & (XE - 1);
    mbar_wait(full + s, (unsigned)k / XE & 1);
    v0 = vals[2 * s], v1 = vals[2 * s + 1];
    mbar_arrive_remote(remote(empty + s, from));
  }
};

// ---- the frame ring -----------------------------------------------------
// Start copying this thread's run (src: its R floats of one frame's row)
// into its place dst of a ring slot, if valid; states past n are not copied.
template <int R>
__device__ __forceinline__ void stage_run(float* dst, const float* src, int jl, int n, bool valid) {
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (jl + r < n) cp4(dst + r, src + r);
}

// This thread's run of R floats of a ring slot.
template <int R>
__device__ __forceinline__ void load_run(const float* p, float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = p[r];
}

// Block-wide reduction of one value per thread (max if MAX, else sum);
// every thread gets the result. red: shared scratch of 32 floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : (MAX ? -INFINITY : 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  return v;
}

// ---- launch geometry -----------------------------------------------------
// A sequence's J states on C blocks: block c takes [c Jc, min(J, (c+1) Jc)),
// Jc = ceil(J / C) rounded up to whole warps of runs of R states (so that a
// block's outermost states sit in its first lane and its last lane); each
// block has the warps of its runs and one warp that carries the cluster
// edge.
__host__ __device__ __forceinline__ int part_states(int J, int R, int C) {
  return ((J + C - 1) / C + 32 * R - 1) / (32 * R) * (32 * R);
}

// Shared memory, in bytes: the cluster edge's barriers, the frame ring
// (rings arrays of D slots of Jc floats), the warp edges (2 parities, nw + 1
// entries, 2 states), the cluster edge's slots, and scratch: 32 floats for
// the block's reductions, MAX_CLUSTER for the cluster's.
__host__ __device__ __forceinline__ size_t smem_bytes(int Jc, int nw, int D, int rings) {
  return 16 * (size_t)XE +
         4 * ((size_t)rings * D * Jc + 4 * (size_t)(nw + 1) + 2 * XE + 32 + MAX_CLUSTER);
}

struct Block {
  int c, C, b, js, n;   // rank, blocks a sequence, sequence, first state, states
  int nw;               // warps of runs (warp nw carries the cluster edge)
  ClusterEdge xe;
  float* ring;          // (rings, D, Jc)
  float* edge;          // (2, nw + 1, 2)
  float* red;           // (32 + MAX_CLUSTER)
};

// This block's part of its sequence and its shared memory. The barriers
// are initialised and, across the cluster, visible when this returns; the
// warp edges are NEG.
__device__ __forceinline__ Block carve(int J, int R, int D, int rings) {
  extern __shared__ uint64_t smem64[];
  Block k;
  uint32_t nct;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nct));
  k.C = (int)nct;
  k.c = cluster_rank();
  k.b = blockIdx.x / k.C;
  const int Jc = part_states(J, R, k.C);
  k.js = k.c * Jc;
  k.n = max(0, min(J, k.js + Jc) - k.js);
  k.nw = blockDim.x / 32 - 1;
  k.xe.full = smem64;
  k.xe.empty = smem64 + XE;
  k.ring = reinterpret_cast<float*>(smem64 + 2 * XE);
  k.edge = k.ring + (size_t)rings * D * Jc;
  k.xe.vals = k.edge + 4 * (k.nw + 1);
  k.red = k.xe.vals + 2 * XE;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * XE; ++i) mbar_init(smem64 + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 4 * (k.nw + 1); i += blockDim.x) k.edge[i] = NEG;
  if (k.C > 1)
    cluster_sync();
  else
    __syncthreads();
  return k;
}

// Sum (MAX: max) one value per block over the blocks of the cluster, in
// rank order; every thread of every block gets the result. v is the
// block's value (the same in all its threads); scratch: MAX_CLUSTER floats.
template <bool MAX>
__device__ float cluster_reduce(float v, float* scratch, const Block& k) {
  if (k.C == 1) return v;
  if (threadIdx.x < k.C) st_remote(remote(scratch + k.c, threadIdx.x), v);
  cluster_sync();
  float r = scratch[0];
  for (int i = 1; i < k.C; ++i) r = MAX ? fmaxf(r, scratch[i]) : r + scratch[i];
  cluster_sync();  // scratch is read before it is written again
  return r;
}

// A warp's two highest states (alpha's edge for the warp above) into e,
// each written by the lane that holds it.
template <int R>
__device__ __forceinline__ void put_top(const float (&cur)[R], float* e, int lane) {
  if constexpr (R == 1) {
    if (lane >= 30) e[lane - 30] = cur[0];
  } else if (lane == 31) {
    e[0] = cur[R - 2], e[1] = cur[R - 1];
  }
}

// A warp's two lowest states (beta's edge for the warp below) into e.
template <int R>
__device__ __forceinline__ void put_bottom(const float (&cur)[R], float* e, int lane) {
  if constexpr (R == 1) {
    if (lane <= 1) e[lane] = cur[0];
  } else if (lane == 0) {
    e[0] = cur[0], e[1] = cur[1];
  }
}

// The two states below a run (alpha: j0 - 2, j0 - 1) from the lanes below,
// at a warp's first lanes from its edge e (the two states below the warp).
template <int R>
__device__ __forceinline__ void states_below(const float (&cur)[R], const float* e, int lane,
                                             float& a2, float& a1) {
  float e0 = 0.f, e1 = 0.f;
  if (lane == 0) e0 = e[0], e1 = e[1];
  if constexpr (R == 1) {
    a1 = __shfl_up_sync(FULL, cur[0], 1);
    a2 = __shfl_up_sync(FULL, cur[0], 2);
    if (lane == 1) a2 = e[1];
  } else {
    a1 = __shfl_up_sync(FULL, cur[R - 1], 1);
    a2 = __shfl_up_sync(FULL, cur[R - 2], 1);
  }
  if (lane == 0) a2 = e0, a1 = e1;
}

// The two states above a run (beta: j0 + R, j0 + R + 1) from the lanes
// above, at a warp's last lanes from its edge e (the two states above it).
template <int R>
__device__ __forceinline__ void states_above(const float (&cur)[R], const float* e, int lane,
                                             float& b1, float& b2) {
  float e0 = 0.f, e1 = 0.f;
  if (lane == 31) e0 = e[0], e1 = e[1];
  if constexpr (R == 1) {
    b1 = __shfl_down_sync(FULL, cur[0], 1);
    b2 = __shfl_down_sync(FULL, cur[0], 2);
    if (lane == 30) b2 = e[0];
  } else {
    b1 = __shfl_down_sync(FULL, cur[0], 1);
    b2 = __shfl_down_sync(FULL, cur[1], 1);
  }
  if (lane == 31) b1 = e0, b2 = e1;
}

template <int R>
__global__ void __launch_bounds__(max_threads(R))
    ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ skipadd,
                     const int* __restrict__ lengths, const int* __restrict__ label_lengths,
                     const float* __restrict__ alpha_in, float* __restrict__ alphas,
                     float* __restrict__ ll, float* __restrict__ alpha_out, int T, int B,
                     int J, int t_offset, int tl_true, int D) {
  const Block k = carve(J, R, D, 1);
  const int nw = k.nw, W = nw * 32 * R;  // floats of a ring slot
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, jl = tid * R, j0 = k.js + jl;
  const bool io = w == nw;  // the warp that carries the cluster edge
  const int b = k.b;
  const int len = lengths[b];
  const int lab = label_lengths[b];
  const size_t row = (size_t)B * J;  // stride of one frame
  const float* src = lp + (size_t)b * J + j0;  // this run in the frame being staged
  float* out = alphas + (size_t)b * J + j0;    // ... in the frame being computed
  float* ring = k.ring + jl;                    // this run in ring slot 0
  // edge entry i + 1 holds the two highest states of warp i after a frame
  // (entry nw: the block's, which go to the next block); entry 0 the two
  // below the block (from the previous block, NEG below state 0)
  const int EP = 2 * (nw + 1);  // floats of one parity of the edges

  float cur[R], sk[R], lpt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool live = !io && jl + r < k.n;
    cur[r] = live ? alpha_in[(size_t)b * J + j0 + r] : NEG;
    sk[r] = live ? skipadd[(size_t)b * J + j0 + r] : NEG;
  }
  if (io) {  // use 0 is sent only if there is a frame to send it in
    if (lane == 0 && k.c > 0 && T > 0) k.xe.take(k.c - 1, 0, k.edge[0], k.edge[1]);
  } else {
    put_top<R>(cur, k.edge + 2 * (w + 1), lane);
    for (int f = 0; f < D - 1; ++f, src += row) {
      stage_run<R>(ring + (size_t)f * W, src, jl, k.n, f < T);
      cp_commit();
    }
    cp_wait(D - 2);  // frame 0
    load_run<R>(ring, lpt);
  }
  __syncthreads();

  // frame f lives in ring slot f % D: the slot frame lt + D - 1 is staged
  // into (the one frame lt - 1 left), and frame lt + 1's
  int par = 0, stage = D - 1, next = 1 % D;  // par: parity of the edges to read
  for (int lt = 0; lt < T; ++lt) {
    if (io) {
      // the block's edge after frame lt - 1 goes to the next block; the
      // previous block's after frame lt comes in for frame lt + 1
      if (lane == 0) {
        if (k.c + 1 < k.C) {
          const float* e = k.edge + par * EP + 2 * nw;
          k.xe.put(k.c + 1, lt, e[0], e[1]);
        }
        if (k.c > 0 && lt + 1 < T) {
          float* e = k.edge + (par ^ 1) * EP;
          k.xe.take(k.c - 1, lt + 1, e[0], e[1]);
        }
      }
    } else {
      float a1, a2;
      states_below<R>(cur, k.edge + par * EP + 2 * w, lane, a2, a1);
      const int t = t_offset + lt;
      if (lt < tl_true && t < len) {
        float nxt[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = j0 + r;
          const float p1 = r >= 1 ? cur[r > 0 ? r - 1 : 0] : a1;
          const float p2 = r >= 2 ? cur[r > 1 ? r - 2 : 0] : (r == 1 ? a1 : a2);
          if (t == 0)
            nxt[r] = (j == 0 || (j == 1 && lab > 0)) ? lpt[r] : NEG;
          else
            nxt[r] = lae(lae(cur[r], p1), p2 + sk[r]) + lpt[r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) cur[r] = nxt[r];
      }
      put_top<R>(cur, k.edge + (par ^ 1) * EP + 2 * (w + 1), lane);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (jl + r < k.n) __stcs(out + r, cur[r]);
      out += row;
      stage_run<R>(ring + (size_t)stage * W, src, jl, k.n, lt + D - 1 < T);
      cp_commit();
      src += row;
      cp_wait(D - 2);  // frame lt + 1
      if (lt + 1 < T) load_run<R>(ring + (size_t)next * W, lpt);
      stage = stage + 1 == D ? 0 : stage + 1;
      next = next + 1 == D ? 0 : next + 1;
    }
    par ^= 1;
    __syncthreads();
  }

  // ll = logsumexp over j of alpha + terminal mask (pallas/ctc.py:132-139)
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    if (!io && jl + r < k.n) {
      m = fmaxf(m, cur[r] + terminal(j, lab));
      alpha_out[(size_t)b * J + j] = cur[r];
    }
  }
  m = cluster_reduce<true>(block_reduce<true>(m, k.red), k.red + 32, k);
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    if (!io && jl + r < k.n) acc += expf(cur[r] + terminal(j, lab) - m);
  }
  acc = cluster_reduce<false>(block_reduce<false>(acc, k.red), k.red + 32, k);
  if (tid == 0 && k.c == 0) ll[b] = m + logf(acc);
}

template <int R>
__global__ void __launch_bounds__(max_threads(R))
    ctc_beta_kernel(const float* __restrict__ lp, const float* __restrict__ alphas,
                    const float* __restrict__ skipadd, const int* __restrict__ lengths,
                    const int* __restrict__ label_lengths, const float* __restrict__ ll_in,
                    const float* __restrict__ cot_in, const float* __restrict__ lpb_in,
                    float* __restrict__ grad, float* __restrict__ lpb_out, int T, int B, int J,
                    int t_offset, int tl_true, int D) {
  const Block k = carve(J, R, D, 2);
  const int nw = k.nw, W = nw * 32 * R;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, jl = tid * R, j0 = k.js + jl;
  const bool io = w == nw;
  const int b = k.b;
  const int len = lengths[b];
  const int lab = label_lengths[b];
  const float ll = ll_in[b];
  const float cot = cot_in[b];
  const size_t row = (size_t)B * J;
  float* ring_lp = k.ring + jl;                   // this run in ring slot 0 (log-probs)
  float* ring_al = k.ring + (size_t)D * W + jl;   // ... (alphas)
  // edge entry i holds the two lowest states of warp i after a frame
  // (entry 0: the block's, which go to the previous block); entry nw the
  // two above the block (from the next block, NEG above state J - 1)
  const int EP = 2 * (nw + 1);

  // frames at or past tl_true write zero and pass the carry through
  const int last = max(0, min(T, tl_true));
  float cur[R], sk2[R], lpt[R], alt[R];  // sk2: the skip into j + 2, NEG past J
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    const bool live = !io && jl + r < k.n;
    cur[r] = live ? lpb_in[(size_t)b * J + j] : NEG;
    sk2[r] = !io && j + 2 < J ? skipadd[(size_t)b * J + j + 2] : NEG;
    if (live)
      for (int lt = last; lt < T; ++lt) __stcs(grad + (size_t)lt * row + (size_t)b * J + j, 0.f);
  }
  // the i-th frame of the loop is lt = last - 1 - i
  const size_t first = (size_t)b * J + j0 + (last > 0 ? (size_t)(last - 1) * row : 0);
  const float *lps = lp + first, *als = alphas + first;  // this run in the frame being staged
  float* out = grad + first;                             // ... in the frame being computed
  if (io) {  // use 0 is sent only if there is a frame to send it in
    if (lane == 31 && k.c + 1 < k.C && last > 0)
      k.xe.take(k.c + 1, 0, k.edge[2 * nw], k.edge[2 * nw + 1]);
  } else {
    put_bottom<R>(cur, k.edge + 2 * w, lane);
    for (int i = 0; i < D - 1; ++i, lps -= row, als -= row) {
      stage_run<R>(ring_lp + (size_t)i * W, lps, jl, k.n, i < last);
      stage_run<R>(ring_al + (size_t)i * W, als, jl, k.n, i < last);
      cp_commit();
    }
    cp_wait(D - 2);
    load_run<R>(ring_lp, lpt);
    load_run<R>(ring_al, alt);
  }
  __syncthreads();

  int par = 0, stage = D - 1, next = 1 % D;  // as in the alpha kernel, by loop frame i
  for (int i = 0; i < last; ++i) {
    const int lt = last - 1 - i;
    if (io) {
      if (lane == 31) {
        if (k.c > 0) {
          const float* e = k.edge + par * EP;
          k.xe.put(k.c - 1, i, e[0], e[1]);
        }
        if (k.c + 1 < k.C && i + 1 < last) {
          float* e = k.edge + (par ^ 1) * EP + 2 * nw;
          k.xe.take(k.c + 1, i + 1, e[0], e[1]);
        }
      }
    } else {
      float b1, b2;
      states_above<R>(cur, k.edge + par * EP + 2 * (w + 1), lane, b1, b2);
      const int t = t_offset + lt;
      float nxt[R], g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        float beta;
        if (t == len - 1) {
          beta = terminal(j, lab);
        } else if (t < len) {
          const float n1 = r + 1 < R ? cur[r + 1 < R ? r + 1 : 0] : b1;
          const float n2 = r + 2 < R ? cur[r + 2 < R ? r + 2 : 0] : (r + 2 == R ? b1 : b2);
          // j -> j+2 is allowed iff the skip into j+2 is
          beta = lae(lae(cur[r], j + 1 < J ? n1 : NEG), (j + 2 < J ? n2 : NEG) + sk2[r]);
        } else {
          beta = NEG;
        }
        g[r] = expf(alt[r] + beta - ll) * cot;
        nxt[r] = lpt[r] + beta;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) cur[r] = nxt[r];
      put_bottom<R>(cur, k.edge + (par ^ 1) * EP + 2 * w, lane);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (jl + r < k.n) __stcs(out + r, g[r]);
      out -= row;
      stage_run<R>(ring_lp + (size_t)stage * W, lps, jl, k.n, i + D - 1 < last);
      stage_run<R>(ring_al + (size_t)stage * W, als, jl, k.n, i + D - 1 < last);
      cp_commit();
      lps -= row, als -= row;
      cp_wait(D - 2);  // loop frame i + 1
      if (i + 1 < last) {
        load_run<R>(ring_lp + (size_t)next * W, lpt);
        load_run<R>(ring_al + (size_t)next * W, alt);
      }
      stage = stage + 1 == D ? 0 : stage + 1;
      next = next + 1 == D ? 0 : next + 1;
    }
    par ^= 1;
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    if (!io && jl + r < k.n) lpb_out[(size_t)b * J + j] = cur[r];
  }
  if (k.C > 1) cluster_sync();  // no block leaves while another may still reach its barriers
}

// launch(std::integral_constant<int, R>) for a run length R the kernels are built for
template <typename Launch>
int dispatch_run(int R, Launch launch) {
  switch (R) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch kernel on B sequences of C blocks each (a cluster of C when C > 1).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int J, int R, int C, int D, int rings, int B, cudaStream_t st,
           Args... args) {
  if (J <= 0 || C < 1 || C > MAX_CLUSTER || D < 2 || D > MAX_RING) return (int)cudaErrorInvalidValue;
  const int Jc = part_states(J, R, C);
  const int nt = Jc / R + 32;  // the warps of runs and the cluster edge's warp
  if (nt > max_threads(R)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Jc, nt / 32 - 1, D, rings);
  int rc = wst_set_smem(kernel, smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

// R: lattice states a thread (1, 2, 4 or 8); C: blocks a sequence (1..4, a
// thread-block cluster); D: frames of the frame ring (2..16).
extern "C" int wst_ctc_alpha_f32(const float* lp, const float* skipadd, const int* lengths,
                                 const int* label_lengths, const float* alpha_in,
                                 float* alphas, float* ll, float* alpha_out, int T, int B,
                                 int J, int t_offset, int tl_true, int R, int C, int D,
                                 void* stream) {
  if (B <= 0) return 0;
  return dispatch_run(R, [&](auto run) {
    return launch(ctc_alpha_kernel<decltype(run)::value>, J, R, C, D, 1, B,
                  static_cast<cudaStream_t>(stream), lp, skipadd, lengths, label_lengths,
                  alpha_in, alphas, ll, alpha_out, T, B, J, t_offset, tl_true, D);
  });
}

extern "C" int wst_ctc_beta_f32(const float* lp, const float* alphas, const float* skipadd,
                                const int* lengths, const int* label_lengths,
                                const float* ll, const float* cot, const float* lpb_in,
                                float* grad, float* lpb_out, int T, int B, int J,
                                int t_offset, int tl_true, int R, int C, int D, void* stream) {
  if (B <= 0) return 0;
  return dispatch_run(R, [&](auto run) {
    return launch(ctc_beta_kernel<decltype(run)::value>, J, R, C, D, 2, B,
                  static_cast<cudaStream_t>(stream), lp, alphas, skipadd, lengths,
                  label_lengths, ll, cot, lpb_in, grad, lpb_out, T, B, J, t_offset, tl_true, D);
  });
}
