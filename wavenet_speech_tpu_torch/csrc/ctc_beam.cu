// CTC prefix beam search for Hopper (sm_90a): one warp a sequence, the
// hypotheses as a prefix tree.
//
// Replaces the Pallas TPU kernel wavenet_speech_tpu/ops/pallas/attic/beam.py
// (_beam_kernel, launched by beam_search_pallas) and computes exactly one
// frame of wavenet_speech_tpu/decoding/ctc_beam_device.py::_beam_step per
// loop iteration (the port's plain version is
// wavenet_speech_tpu_torch/decoding/ctc_beam_device.py::_beam_step):
//
//   stay(w)    = prefix w extended by blank or by its own last label
//   extend(v,k)= prefix v + candidate label k (all C labels, or the frame's
//                top-K when pruned; lax.top_k order: value desc, lower label
//                first on ties)
//   merge      : stay(w) absorbs extend(v, last_w) when prefix_v + last_w ==
//                prefix_w (v is w's parent, w alive); the extension leaves
//                the pool. w adopts the times of the dominant parent (the
//                first maximum over v) when the merged-in mass beats its own.
//   top-W      : over [stay(0..W) | extend(v, k) row-major], by total
//                log-probability, ties to the lower flat index (so stay beats
//                extend), as lax.top_k does. Dead candidates (-1e30) keep
//                their -1e30 mass, so a dead slot stays dead.
//
// Like beam_scan, a call takes a beam state (or starts from the empty beam)
// and the global index t0 of its first frame, and returns the state.
//
// What bounds it on an H100: not bytes (the log-probs and the final beam are
// ~2 MB at the serving shape) and not operations (a few hundred a frame),
// but the chain of dependent frames: each frame needs the previous one's
// beam. So a frame's latency is all there is to cut. The design:
//
//   - One warp a sequence, lane r = beam r (W <= 32). The frame's three
//     phases (merge, candidates, selection) meet at __syncwarp, never at a
//     block barrier, and the beam's scalars are double-buffered in shared
//     memory so that one barrier a phase does.
//   - The selection ranks only the candidates not below the worst stay
//     candidate (the W stays outrank the rest): ~14 of 42 at the serving
//     shape, packed by ballot. The owner of rank r writes row r.
//   - Hypotheses are nodes (parent node, label, emission frame) in a pool,
//     not rows: node 0 is the empty prefix, a frame appends at most W nodes
//     (an extension, or a stay that adopts its parent's times), and the rows
//     are written once, at the end, by walking each beam's chain. A frame's
//     work is O(W*K + W^2) whatever the decoded length. The pool (1 + W*T
//     nodes, plus the input state's trie) lives in shared memory where it
//     fits (~95 KB at the serving shape), else in a scratch tensor.
//   - The parent test is exact: v is w's parent when plen_w == plen_v + 1
//     and parent(node_w) holds node_v's prefix. A beam carries the
//     polynomial hash of its prefix and of its parent's; a hash that differs
//     proves the prefixes differ, in one compare. Equal hashes are confirmed
//     on the nodes: equal ids mean equal prefixes, and different ids (a
//     prefix rebuilt as a second node) are walked up both chains, of equal
//     depth, until the ids meet (parent) or the labels differ (not).
//   - The frame's log-probs come a chunk of up to 32 frames at a time, the
//     next chunk copied by cp.async while this one is read.
//
// Limits: W <= 32 (MAXW), K <= C, the frame's arrays in shared memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int MAXW = 32;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t STATIC_SMEM = 4096;  // the kernel's static shared arrays, rounded up
// Prefix hash: h(labels) = sum_s (label_s + 1) * HASH_P^s mod 2^32, a function
// of the prefix alone. Different hashes prove different prefixes; equal ones
// are confirmed on the nodes, so the parent test stays exact.
constexpr unsigned HASH_P = 0x9E3779B1u;

// torch.logaddexp / jnp.logaddexp for finite inputs: max + log1p(exp(-|a-b|)).
// Past |a-b| = 110, exp underflows to 0 and the result is the max exactly;
// at a == b it is max + log1p(1), which the caller computes once (ln2).
__device__ __forceinline__ float logaddexp_f(float a, float b, float ln2) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  const float d = fabsf(a - b);
  if (d > 110.f) return m;
  if (d == 0.f) return m + ln2;
  return m + log1pf(expf(-d));
}

// Candidate y at index j ranks above candidate x at index i: higher value,
// or an equal value at a lower index (lax.top_k's order).
__device__ __forceinline__ int beats(float y, int j, float x, int i) {
  return (y > x) || (y == x && j < i);
}

// An unsigned key in the order of the floats (for a warp minimum), and back.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Node of input row q at position s of the initial trie: row q shares its
// first lcp[q] nodes with row best[q] and owns base[q] + (s - lcp[q]) after.
__device__ __forceinline__ int trie_node(const int* best, const int* lcp, const int* base,
                                         int q, int s) {
  while (s < lcp[q]) q = best[q];
  return base[q] + s - lcp[q];
}

// Frames of log-probs a chunk: two chunks in shared memory, at most 16 KB.
__host__ __device__ __forceinline__ int chunk_frames(int C) {
  return C >= 2048 ? 1 : (C > 64 ? 2048 / C : 32);
}

// x^n mod 2^32.
__device__ __forceinline__ unsigned upow(unsigned x, int n) {
  unsigned y = 1u;
  for (; n > 0; n >>= 1, x *= x)
    if (n & 1) y *= x;
  return y;
}

// Bytes of dynamic shared memory besides the pool: the surviving candidates
// (total, index) and their (v, k), extension masses and their
// consumed-stamps, the log-prob chunks, and the pruned path's labels.
size_t frame_smem(int C, int W, int K) {
  const size_t N = (size_t)W + (size_t)W * K;
  return 4 * (4 * (N + 3) + 2 * (size_t)W * K + 2 * (size_t)chunk_frames(C) * C + 2 * (size_t)K +
              C);
}

template <bool kSharedPool>
__global__ void __launch_bounds__(32)
ctc_beam_kernel(const float* __restrict__ lp, const int* __restrict__ lengths,
                const int* __restrict__ pref_in, const int* __restrict__ plen_in,
                const float* __restrict__ pb_in, const float* __restrict__ pnb_in,
                const int* __restrict__ times_in, int* __restrict__ pool_g,
                int* __restrict__ pref_out, int* __restrict__ plen_out,
                float* __restrict__ pb_out, float* __restrict__ pnb_out,
                int* __restrict__ times_out, int T, int C, int W, int S, int K, int blank,
                int t0, int cap) {
  extern __shared__ float4 smem4[];
  const int N = W + W * K;  // candidates: W stay + W*K extend
  const int CH = chunk_frames(C);
  float2* surv = reinterpret_cast<float2*>(smem4);   // (N + 3,) survivors: total, index bits
  int2* surv_vk = reinterpret_cast<int2*>(surv + N + 3);  // (N + 3,) a survivor's (v, k)
  float* ext = reinterpret_cast<float*>(surv_vk + N + 3);  // (W*K,) extend pnb, row-major (v, k)
  int* stamp = reinterpret_cast<int*>(ext + W * K);  // (W*K,) frame that consumed ext(v, k)
  float* ring = reinterpret_cast<float*>(stamp + W * K);  // (2, CH, C) log-probs
  float* lpk_s = ring + 2 * CH * C;                       // (K,) pruned: candidate log-probs
  int* labk_s = reinterpret_cast<int*>(lpk_s + K);        // (K,) pruned: candidate labels
  int* kslot_s = labk_s + K;                              // (C,) pruned: slot of label c or -1
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  int* pool = kSharedPool ? kslot_s + C : pool_g + (size_t)b * 3 * cap;
  int* npar = pool;            // parent node (-1 for the root)
  int* nlab = pool + cap;      // label
  int* ntim = pool + 2 * cap;  // emission frame

  // the beam, double-buffered by frame parity: the rows of frame t + 1 are
  // written while other lanes may still read frame t's. h, ph: prefix hash
  // of the node and of its parent; pw = HASH_P^plen
  __shared__ __align__(16) int s_node[2][MAXW], s_pnode[2][MAXW], s_plen[2][MAXW],
      s_last[2][MAXW];
  __shared__ __align__(16) float s_pb[2][MAXW], s_pnb[2][MAXW], s_tot[2][MAXW];
  __shared__ __align__(16) unsigned s_h[2][MAXW], s_ph[2][MAXW], s_pw[2][MAXW];
  // this frame's stay candidates and merges
  __shared__ float s_spb[MAXW], s_spnb[MAXW];
  __shared__ int s_adopt[MAXW];
  // the input state's trie
  __shared__ int s_best[MAXW], s_lcp[MAXW], s_base[MAXW + 1];

  const float ln2 = log1pf(1.f);
  auto lae = [ln2](float a, float b) { return logaddexp_f(a, b, ln2); };
  for (int i = lane; i < W * K; i += 32) stamp[i] = -1;
  if (lane == 0) {
    npar[0] = -1;
    nlab[0] = -1;
    ntim[0] = 0;
  }

  // ---- the initial beam: the empty prefix, or the input state as a trie
  int n_in = 1;  // nodes before this call's first frame
  if (pref_in == nullptr) {
    if (lane < W) {
      s_node[0][lane] = 0;
      s_pnode[0][lane] = -1;
      s_plen[0][lane] = 0;
      s_last[0][lane] = -1;
      s_pb[0][lane] = lane == 0 ? 0.f : NEG;
      s_pnb[0][lane] = NEG;
      s_h[0][lane] = 0u;
      s_ph[0][lane] = 0u;
      s_pw[0][lane] = 1u;
    }
  } else {
    const int* P = pref_in + (size_t)b * W * S;
    const int* Tm = times_in + (size_t)b * W * S;
    if (lane < W) s_plen[0][lane] = min(max(plen_in[b * W + lane], 0), S);
    __syncwarp();
    // each row shares its longest common (label, time) prefix with an
    // earlier row (the first longest), found by the warp 32 positions a
    // step; and its prefix hashes, summed by the warp
    const unsigned p_lane = upow(HASH_P, lane), p_32 = upow(HASH_P, 32);
    for (int r = 0; r < W; ++r) {
      const int nr = s_plen[0][r];
      int best = -1, bl = 0;
      for (int q = 0; q < r; ++q) {
        const int n = min(nr, s_plen[0][q]);
        if (n <= bl) continue;
        int l = n;
        for (int s0 = 0; s0 < n; s0 += 32) {
          const int s = s0 + lane;
          const bool ne = s < n && (P[q * S + s] != P[r * S + s] || Tm[q * S + s] != Tm[r * S + s]);
          const unsigned m = __ballot_sync(FULL, ne);
          if (m) {
            l = s0 + __ffs(m) - 1;
            break;
          }
        }
        if (l > bl) {
          bl = l;
          best = q;
        }
      }
      unsigned h = 0u, ph = 0u, pws = p_lane;
      for (int s = lane; s < nr; s += 32, pws *= p_32) {
        const unsigned term = (unsigned)(P[r * S + s] + 1) * pws;
        h += term;
        ph += s < nr - 1 ? term : 0u;
      }
      h = __reduce_add_sync(FULL, h);
      ph = __reduce_add_sync(FULL, ph);
      if (lane == 0) {
        s_best[r] = best;
        s_lcp[r] = bl;
        s_h[0][r] = h;
        s_ph[0][r] = ph;
        s_pw[0][r] = upow(HASH_P, nr);
      }
    }
    if (lane == 0) {
      int base = 1;
      for (int r = 0; r < W; ++r) {
        s_base[r] = base;
        base += s_plen[0][r] - s_lcp[r];
      }
      s_base[W] = base;
    }
    __syncwarp();
    for (int r = 0; r < W; ++r) {  // each row's own nodes, the warp together
      const int l = s_lcp[r], n = s_plen[0][r], base = s_base[r];
      for (int s = l + lane; s < n; s += 32) {
        const int id = base + s - l;
        npar[id] = s > l    ? id - 1
                   : s == 0 ? 0
                            : trie_node(s_best, s_lcp, s_base, s_best[r], s - 1);
        nlab[id] = P[r * S + s];
        ntim[id] = Tm[r * S + s];
      }
    }
    if (lane < W) {
      const int n = s_plen[0][lane];
      s_node[0][lane] = n > 0 ? trie_node(s_best, s_lcp, s_base, lane, n - 1) : 0;
      s_pnode[0][lane] = n > 1 ? trie_node(s_best, s_lcp, s_base, lane, n - 2) : n - 1;
      s_last[0][lane] = n > 0 ? P[lane * S + n - 1] : -1;
      s_pb[0][lane] = pb_in[b * W + lane];
      s_pnb[0][lane] = pnb_in[b * W + lane];
    }
    n_in = s_base[W];
  }
  if (lane < W) s_tot[0][lane] = lae(s_pb[0][lane], s_pnb[0][lane]);

  // ---- the frames: global index t0 + t; frames past lengths[b] carry the
  // state. The log-probs come a chunk of CH frames at a time, the next chunk
  // copied while this one is read.
  const int Tb = min(T, max(lengths[b] - t0, 0));
  const float* lpb = lp + (size_t)b * T * C;
  auto load_chunk = [&](int c) {  // frames [c * CH, (c + 1) * CH) into buffer c & 1
    const int f0 = c * CH, n = min(CH, Tb - f0) * C;
    float* dst = ring + (c & 1) * CH * C;
    for (int i = lane; i < n; i += 32) cp_async4(dst + i, lpb + (size_t)f0 * C + i);
    cp_async_commit();
  };
  load_chunk(0);
  const int r = min(lane, W - 1);  // lane r holds beam r; lanes past W repeat W - 1
  const float mass0 = logf((float)W) + NEG;  // the merge with no parent: W terms exp(0)
  const int NJ = (N + 31) / 32;              // candidates a lane: i = lane + 32 j
  // (v, k) of the extension candidates i = lane and lane + 32, for every frame
  const int e0 = max(lane - W, 0), e1 = min(lane + 32 - W, W * K - 1);
  const int v0 = e0 / K, k0 = e0 - v0 * K, v1 = e1 / K, k1 = e1 - v1 * K;
  for (int t = 0, ct = 0; t < Tb; ++t, ++ct) {
    const int cur = t & 1, nxt = cur ^ 1;
    const int tg = t0 + t;
    if (ct == CH) ct = 0;
    if (ct == 0) {  // every lane is past the chunk the next one overwrites
      load_chunk(t / CH + 1);
      cp_async_wait<1>();
    }
    __syncwarp();
    const float* lpf = ring + ((t / CH) & 1) * CH * C + ct * C;
    if (K < C) {  // the frame's top-K labels, lax.top_k order
      for (int c = lane; c < C; c += 32) {
        const float x = lpf[c];
        int rank = 0;
        for (int j = 0; j < C; ++j) {
          const float y = lpf[j];
          rank += (y > x) || (y == x && j < c);
        }
        const int slot = rank < K ? rank : -1;
        kslot_s[c] = slot;
        if (slot >= 0) {
          labk_s[slot] = c;
          lpk_s[slot] = x;
        }
      }
      __syncwarp();
    }
    const float* lpk = K < C ? lpk_s : lpf;

    // D. lane r: its beam's stay candidate, its parents, the merge; every
    // lane: its extension candidates before the merge
    const int plen = s_plen[cur][r], last = s_last[cur][r];
    const float tot = s_tot[cur][r];
    const unsigned h = s_h[cur][r], ph = s_ph[cur][r];
    const float lp_last = last >= 0 ? lpf[last] : NEG;
    const float spb = tot + lpf[blank];
    const float spnb = s_pnb[cur][r] + lp_last;
    const int ks = last < 0 ? -1 : (K < C ? kslot_s[last] : last);
    // parents by length and hash (a different hash proves another prefix)
    auto hash_parents = [&](int v4) {  // beams v4 .. v4 + 3, one load each
      const int4 pl = *reinterpret_cast<const int4*>(&s_plen[cur][v4]);
      const uint4 hv = *reinterpret_cast<const uint4*>(&s_h[cur][v4]);
      const unsigned m = (unsigned)(pl.x + 1 == plen && hv.x == ph) |
                         (unsigned)(pl.y + 1 == plen && hv.y == ph) << 1 |
                         (unsigned)(pl.z + 1 == plen && hv.z == ph) << 2 |
                         (unsigned)(pl.w + 1 == plen && hv.w == ph) << 3;
      return m << v4;
    };
    unsigned hp = hash_parents(0) | hash_parents(4);
    for (int v4 = 8; v4 < W; v4 += 4) hp |= hash_parents(v4);
    if (W < 32) hp &= (1u << W) - 1;  // entries past W are not beams
    auto ext_pre = [&](int i, int v, int k) {  // ext(v, k), before the merge
      const int lab = K < C ? labk_s[k] : k;
      const float x = (lab == s_last[cur][v] ? s_pb[cur][v] : s_tot[cur][v]) + lpk[k];
      if (i >= W && i < N) ext[i - W] = lab == blank || s_plen[cur][v] >= S ? NEG : x;
    };
    ext_pre(lane, v0, k0);
    ext_pre(lane + 32, v1, k1);
    for (int j = 2; j < NJ; ++j) {
      const int i = lane + 32 * j, e = min(i, N - 1) - W, v = e / K;
      ext_pre(i, v, e - v * K);
    }
    const float stay = lae(spb, spnb);
    unsigned pm = 0;  // bit v: v is r's parent and ext(v, last_r) is a candidate
    if (ks >= 0 && tot > NEG / 2) {
      const int pn = s_pnode[cur][r];
      for (unsigned m = hp; m; m &= m - 1) {  // equal hashes: equal ids, or walk
        const int v = __ffs(m) - 1;
        int x = pn, y = s_node[cur][v];
        while (x != y && nlab[x] == nlab[y]) {
          x = npar[x];
          y = npar[y];
        }
        if (x == y) pm |= 1u << v;
      }
    }
    // logsumexp over v of ext(v, last_r) for parents, -1e30 for the rest;
    // vstar the first maximum. With no parent it is mass0.
    float mass = mass0;
    int vstar = 0;
    auto extv = [&](int v) -> float {
      if (last == blank || s_plen[cur][v] >= S) return NEG;
      return (last == s_last[cur][v] ? s_pb[cur][v] : s_tot[cur][v]) + lp_last;
    };
    const float cv1 = pm ? extv(__ffs(pm) - 1) : NEG;
    if ((pm & (pm - 1)) == 0 && cv1 > NEG / 2) {
      // one live parent: exp(NEG - cv) = 0, so the sum below is 1 and the
      // mass is its contribution, bit for bit
      mass = cv1;
      vstar = __ffs(pm) - 1;
    } else if (pm) {
      const int nc = W - __popc(pm);
      float mx = nc > 0 ? NEG : 2.f * NEG;
      for (unsigned m = pm; m; m &= m - 1) {
        const int v = __ffs(m) - 1;
        const float cv = extv(v);
        if (cv > mx) {
          mx = cv;
          vstar = v;
        }
      }
      float sum = nc > 0 ? (float)nc * expf(NEG - mx) : 0.f;
      for (unsigned m = pm; m; m &= m - 1) sum += expf(extv(__ffs(m) - 1) - mx);
      mass = logf(sum) + mx;
    }
    const float spnb2 = lae(spnb, mass);
    const float sval = spnb2 == spnb ? stay : lae(spb, spnb2);
    // the worst stay: the W stays rank above any candidate below it, which
    // therefore cannot be selected
    const float tau = key_float(__reduce_min_sync(FULL, float_key(sval)));
    if (lane < W) {
      s_spb[r] = spb;
      s_spnb[r] = spnb2;
      s_adopt[r] = mass > stay ? s_node[cur][vstar] : -1;
      for (unsigned m = pm; m; m &= m - 1) stamp[(__ffs(m) - 1) * K + ks] = t;  // consumed
    }
    __syncwarp();

    // E. candidates i = lane (mod 32): consumed extensions out; those not
    // below tau survive, packed in index order by ballot
    int M = 0;
    const unsigned below = (1u << lane) - 1;
    auto survive = [&](int i, int v, int k) {  // every lane calls it: a ballot
      float x = sval;
      if (i >= W && i < N) {
        const int e = i - W;
        float xe = ext[e];
        if (stamp[e] == t) ext[e] = xe = NEG;
        x = lae(NEG, xe);
      }
      const bool keep = i < N && x >= tau;
      const unsigned m = __ballot_sync(FULL, keep);
      if (keep) {
        const int p = M + __popc(m & below);
        surv[p] = make_float2(x, __int_as_float(i));
        surv_vk[p] = make_int2(v, k);
      }
      M += __popc(m);
    };
    survive(lane, v0, k0);
    if (NJ > 1) survive(lane + 32, v1, k1);
    for (int j = 2; j < NJ; ++j) {
      const int i = lane + 32 * j, v = (i - W) / K;
      survive(i, v, i - W - v * K);
    }
    if (lane < 3) surv[M + lane] = make_float2(-INFINITY, __int_as_float(INT_MAX));  // pad to 4
    __syncwarp();

    // F. each survivor's rank among the survivors; the owner of rank rr < W
    // writes row rr of the next beam: a kept node, or one new node at slot rr
    auto new_row = [&](int rr, int i, int v, int k, float total) {
      const bool is_ext = i >= W;
      const int src = is_ext ? v : i;  // the row the candidate grows from
      const int st = is_ext ? 0 : i, e = is_ext ? i - W : 0;  // in-range indices either way
      const int id = n_in + t * W + rr;
      const int node_s = s_node[cur][src], plen_s = s_plen[cur][src], last_s = s_last[cur][src];
      const unsigned h_s = s_h[cur][src], pw_s = s_pw[cur][src];
      const int a = is_ext ? -1 : s_adopt[st];  // a stay's dominant parent, if it adopts
      const bool room = is_ext && plen_s < S;   // an extension appends its label
      const int lab = is_ext ? (K < C ? labk_s[k] : k) : last_s;
      const int pnode = room ? node_s : a >= 0 ? a : s_pnode[cur][src];
      if (room || a >= 0) {  // a new node: this frame's label, or the adopted times
        npar[id] = pnode;
        nlab[id] = lab;
        ntim[id] = tg;
      }
      s_node[nxt][rr] = room || a >= 0 ? id : node_s;
      s_pnode[nxt][rr] = pnode;
      s_plen[nxt][rr] = plen_s + room;
      s_last[nxt][rr] = room ? lab : last_s;
      s_pb[nxt][rr] = is_ext ? NEG : s_spb[st];
      s_pnb[nxt][rr] = is_ext ? ext[e] : s_spnb[st];
      s_tot[nxt][rr] = total;  // logaddexp(pb, pnb): the candidate's total
      s_h[nxt][rr] = room ? h_s + (unsigned)(lab + 1) * pw_s : h_s;
      s_ph[nxt][rr] = room ? h_s : s_ph[cur][src];
      s_pw[nxt][rr] = room ? pw_s * HASH_P : pw_s;
    };
    for (int p = lane; p < M; p += 32) {
      const float2 me = surv[p];
      const int i = __float_as_int(me.y);
      int rank = 0;
      for (int q = 0; q < M; q += 4) {  // two survivors a load
        const float4 y01 = *reinterpret_cast<const float4*>(&surv[q]);
        const float4 y23 = *reinterpret_cast<const float4*>(&surv[q + 2]);
        rank += beats(y01.x, __float_as_int(y01.y), me.x, i) +
                beats(y01.z, __float_as_int(y01.w), me.x, i) +
                beats(y23.x, __float_as_int(y23.y), me.x, i) +
                beats(y23.z, __float_as_int(y23.w), me.x, i);
      }
      if (rank < W) {
        const int2 vk = surv_vk[p];
        new_row(rank, i, vk.x, vk.y, me.x);
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  // ---- the rows, once: each lane walks its beam's chain back to the root;
  // zero past each row's length, as the JAX state holds it
  const int fin = Tb & 1;
  int* po = pref_out + (size_t)b * W * S;
  int* to = times_out + (size_t)b * W * S;
  if (lane < W) {
    const int n = s_plen[fin][lane];
    int node = s_node[fin][lane];
    for (int s = n - 1; s >= 0; --s) {
      po[lane * S + s] = nlab[node];
      to[lane * S + s] = ntim[node];
      node = npar[node];
    }
    plen_out[b * W + lane] = n;
    pb_out[b * W + lane] = s_pb[fin][lane];
    pnb_out[b * W + lane] = s_pnb[fin][lane];
  }
  for (int r = 0; r < W; ++r)
    for (int s = s_plen[fin][r] + lane; s < S; s += 32) {
      po[r * S + s] = 0;
      to[r * S + s] = 0;
    }
}

int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

bool pool_fits(int C, int W, int K, int cap) {
  return frame_smem(C, W, K) + 12 * (size_t)cap + STATIC_SMEM <= (size_t)max_smem();
}

}  // namespace

// 1 when a pool of cap nodes fits in shared memory beside the frame's
// arrays (the kernel then takes no pool pointer), 0 when the caller must
// pass a (B, 3, cap) int32 scratch pool.
extern "C" int wst_ctc_beam_pool_in_shared(int C, int W, int K, int cap) {
  return pool_fits(C, W, K, cap) ? 1 : 0;
}

// pref_in .. times_in: the input beam state, all null for the empty beam.
// pool: null when wst_ctc_beam_pool_in_shared says so. cap: pool nodes,
// at least 1 + max over b of sum_r plen_in[b, r] + W * T.
extern "C" int wst_ctc_beam_f32(const float* lp, const int* lengths, const int* pref_in,
                                const int* plen_in, const float* pb_in, const float* pnb_in,
                                const int* times_in, int* pool, int* pref_out, int* plen_out,
                                float* pb_out, float* pnb_out, int* times_out, int B, int T,
                                int C, int W, int S, int K, int blank, int t0, int cap,
                                void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > MAXW || K < 1 || K > C || S < 1 || blank < 0 || blank >= C || cap < 1)
    return (int)cudaErrorInvalidValue;
  const bool shared = pool_fits(C, W, K, cap);
  size_t smem = frame_smem(C, W, K);
  if (smem + STATIC_SMEM > (size_t)max_smem() || (!shared && pool == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (shared) {
    smem += 12 * (size_t)cap;
    if ((rc = wst_set_smem(ctc_beam_kernel<true>, smem))) return rc;
    ctc_beam_kernel<true><<<B, 32, smem, st>>>(lp, lengths, pref_in, plen_in, pb_in, pnb_in,
                                               times_in, nullptr, pref_out, plen_out, pb_out,
                                               pnb_out, times_out, T, C, W, S, K, blank, t0,
                                               cap);
  } else {
    if ((rc = wst_set_smem(ctc_beam_kernel<false>, smem))) return rc;
    ctc_beam_kernel<false><<<B, 32, smem, st>>>(lp, lengths, pref_in, plen_in, pb_in, pnb_in,
                                                times_in, pool, pref_out, plen_out, pb_out,
                                                pnb_out, times_out, T, C, W, S, K, blank, t0,
                                                cap);
  }
  return (int)cudaGetLastError();
}
