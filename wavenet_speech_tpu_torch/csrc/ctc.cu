// CTC alpha (forward) and beta (backward) recursions over extended-label
// log-probs, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels wavenet_speech_tpu/ops/pallas/ctc.py:
//   wst_ctc_alpha_f32  <- _fwd_kernel (B1, launched by _ctc_fwd_impl)
//   wst_ctc_beta_f32   <- _bwd_kernel (B2, launched by _ctc_bwd_impl)
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
// reads 31 MB and writes 31 MB, B2 reads 62 MB and writes 31 MB, which the
// card's 3.35 TB/s moves in 0.02-0.03 ms. The real limit is the chain of T
// dependent frames on B blocks.
//
// What the design does about it: one block a sequence, the states across
// threads (up to 8 a thread), the state double-buffered in shared memory
// beside the skip mask, one barrier a frame. Each thread loads its next frame's log-probs (and
// alphas, for B2) into registers before the barrier, so the loads of frame
// t+1 overlap frame t and no frame waits on device memory. The TPU kernel's
// time chunking existed only to fit its VMEM and is not ported.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int SPT = 8;  // lattice states per thread at most (J <= SPT * blockDim.x)

__device__ __forceinline__ float lae(float a, float b) {
  const float d = a - b;
  if (isnan(d)) return a + b;
  return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

__device__ __forceinline__ float terminal(int j, int lab) {
  return (j == 2 * lab || (j == 2 * lab - 1 && lab > 0)) ? 0.f : NEG;
}

// Block-wide reduction of one value per thread (max if MAX, else sum);
// every thread gets the result. red: shared scratch of 32 floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : (MAX ? -INFINITY : 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  return v;
}

__global__ void __launch_bounds__(1024) ctc_alpha_kernel(const float* __restrict__ lp,
                                 const float* __restrict__ skipadd,
                                 const int* __restrict__ lengths,
                                 const int* __restrict__ label_lengths,
                                 const float* __restrict__ alpha_in,
                                 float* __restrict__ alphas, float* __restrict__ ll,
                                 float* __restrict__ alpha_out, int T, int B, int J,
                                 int t_offset, int tl_true) {
  extern __shared__ float smem[];
  float* buf0 = smem;           // (J) alpha, ping
  float* buf1 = smem + J;       // (J) alpha, pong
  float* sk = smem + 2 * J;     // (J) additive skip mask
  float* red = smem + 3 * J;    // (32) reduction scratch
  const int b = blockIdx.x;
  const int len = lengths[b];
  const int lab = label_lengths[b];
  const size_t row = (size_t)B * J;  // stride of one frame
  const float* lpseq = lp + (size_t)b * J;
  float* alb = alphas + (size_t)b * J;

  float cur[SPT], nxt[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    cur[s] = NEG;
    nxt[s] = 0.f;
    if (j < J) {
      sk[j] = skipadd[(size_t)b * J + j];
      cur[s] = alpha_in[(size_t)b * J + j];
      buf0[j] = cur[s];
      if (T > 0) nxt[s] = lpseq[j];
    }
  }
  __syncthreads();
  float* prev = buf0;
  float* next = buf1;
  for (int lt = 0; lt < T; ++lt) {
    const int t = t_offset + lt;
    const bool live = lt < tl_true && t < len;
    float lpt[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      lpt[s] = nxt[s];
      if (j < J && lt + 1 < T) nxt[s] = lpseq[(size_t)(lt + 1) * row + j];
    }
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      if (j >= J) continue;
      float a = cur[s];
      if (live) {
        if (t == 0) {
          a = (j == 0 || (j == 1 && lab > 0)) ? lpt[s] : NEG;
        } else {
          const float a1 = j >= 1 ? prev[j - 1] : NEG;
          const float a2 = j >= 2 ? prev[j - 2] : NEG;
          a = lae(lae(cur[s], a1), a2 + sk[j]) + lpt[s];
        }
      }
      cur[s] = a;
      next[j] = a;
      alb[(size_t)lt * row + j] = a;
    }
    __syncthreads();
    float* tmp = prev;
    prev = next;
    next = tmp;
  }

  // ll = logsumexp over j of alpha + terminal mask (pallas/ctc.py:132-139)
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    if (j < J) {
      m = fmaxf(m, cur[s] + terminal(j, lab));
      alpha_out[(size_t)b * J + j] = cur[s];
    }
  }
  m = block_reduce<true>(m, red);
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    if (j < J) acc += expf(cur[s] + terminal(j, lab) - m);
  }
  acc = block_reduce<false>(acc, red);
  if (threadIdx.x == 0) ll[b] = m + logf(acc);
}

__global__ void __launch_bounds__(1024) ctc_beta_kernel(const float* __restrict__ lp,
                                const float* __restrict__ alphas,
                                const float* __restrict__ skipadd,
                                const int* __restrict__ lengths,
                                const int* __restrict__ label_lengths,
                                const float* __restrict__ ll_in,
                                const float* __restrict__ cot_in,
                                const float* __restrict__ lpb_in,
                                float* __restrict__ grad, float* __restrict__ lpb_out,
                                int T, int B, int J, int t_offset, int tl_true) {
  extern __shared__ float smem[];
  float* buf0 = smem;         // (J) lp + beta, ping
  float* buf1 = smem + J;     // (J) lp + beta, pong
  float* sk = smem + 2 * J;   // (J) additive skip mask
  const int b = blockIdx.x;
  const int len = lengths[b];
  const int lab = label_lengths[b];
  const float ll = ll_in[b];
  const float cot = cot_in[b];
  const size_t row = (size_t)B * J;
  const float* lpseq = lp + (size_t)b * J;
  const float* alb = alphas + (size_t)b * J;
  float* gb = grad + (size_t)b * J;

  // frames at or past tl_true write zero and pass the carry through
  const int last = T < tl_true ? T : tl_true;
  float cur[SPT], nlp[SPT], nal[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    cur[s] = NEG;
    nlp[s] = 0.f;
    nal[s] = 0.f;
    if (j < J) {
      sk[j] = skipadd[(size_t)b * J + j];
      cur[s] = lpb_in[(size_t)b * J + j];
      buf0[j] = cur[s];
      for (int lt = last; lt < T; ++lt) gb[(size_t)lt * row + j] = 0.f;
      if (last > 0) {
        nlp[s] = lpseq[(size_t)(last - 1) * row + j];
        nal[s] = alb[(size_t)(last - 1) * row + j];
      }
    }
  }
  __syncthreads();
  float* prev = buf0;
  float* next = buf1;
  for (int lt = last - 1; lt >= 0; --lt) {
    const int t = t_offset + lt;
    float lpt[SPT], alt[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      lpt[s] = nlp[s];
      alt[s] = nal[s];
      if (j < J && lt > 0) {
        nlp[s] = lpseq[(size_t)(lt - 1) * row + j];
        nal[s] = alb[(size_t)(lt - 1) * row + j];
      }
    }
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int j = threadIdx.x + s * blockDim.x;
      if (j >= J) continue;
      float beta;
      if (t == len - 1) {
        beta = terminal(j, lab);
      } else if (t < len) {
        const float b1 = j + 1 < J ? prev[j + 1] : NEG;
        const float b2 = j + 2 < J ? prev[j + 2] : NEG;
        // j -> j+2 is allowed iff the skip into j+2 is
        beta = lae(lae(cur[s], b1), b2 + (j + 2 < J ? sk[j + 2] : NEG));
      } else {
        beta = NEG;
      }
      gb[(size_t)lt * row + j] = expf(alt[s] + beta - ll) * cot;
      cur[s] = lpt[s] + beta;
      next[j] = cur[s];
    }
    __syncthreads();
    float* tmp = prev;
    prev = next;
    next = tmp;
  }
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    if (j < J) lpb_out[(size_t)b * J + j] = cur[s];
  }
}

// One thread a lattice state up to 1024 states, then up to SPT a thread.
int threads_for(int J) {
  const int n = (J + 31) / 32 * 32;
  return n > 1024 ? 1024 : n;
}

}  // namespace

extern "C" int wst_ctc_alpha_f32(const float* lp, const float* skipadd, const int* lengths,
                                 const int* label_lengths, const float* alpha_in,
                                 float* alphas, float* ll, float* alpha_out, int T, int B,
                                 int J, int t_offset, int tl_true, void* stream) {
  if (B <= 0) return 0;
  const int nt = threads_for(J);
  if (J <= 0 || J > SPT * nt) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * (size_t)J + 32);
  int rc = wst_set_smem(ctc_alpha_kernel, smem);
  if (rc) return rc;
  ctc_alpha_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      lp, skipadd, lengths, label_lengths, alpha_in, alphas, ll, alpha_out, T, B, J,
      t_offset, tl_true);
  return (int)cudaGetLastError();
}

extern "C" int wst_ctc_beta_f32(const float* lp, const float* alphas, const float* skipadd,
                                const int* lengths, const int* label_lengths,
                                const float* ll, const float* cot, const float* lpb_in,
                                float* grad, float* lpb_out, int T, int B, int J,
                                int t_offset, int tl_true, void* stream) {
  if (B <= 0) return 0;
  const int nt = threads_for(J);
  if (J <= 0 || J > SPT * nt) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * (size_t)J;
  int rc = wst_set_smem(ctc_beta_kernel, smem);
  if (rc) return rc;
  ctc_beta_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      lp, alphas, skipadd, lengths, label_lengths, ll, cot, lpb_in, grad, lpb_out, T, B,
      J, t_offset, tl_true);
  return (int)cudaGetLastError();
}
