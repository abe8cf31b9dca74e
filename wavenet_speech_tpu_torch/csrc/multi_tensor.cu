// The train step's skip guard and optimizer over whole lists of tensors,
// float32, for Hopper (sm_90a): a few launches a stage over every leaf of a
// tree, where PyTorch's elementwise operators took 1-7 launches a leaf.
//
// Replaces no TPU kernel: under jit, XLA fused the guard and optax's rules
// of wavenet_speech_tpu/training/{trainer,optimizer}.py into a few fusions
// over the whole tree. Eager PyTorch launched each operator on each leaf
// (~26 launches a leaf, 10,493 a step at 402 leaves), and the host's time
// spent launching them set the pace of the step.
//
// Lists. A launch reads a table of int64 words in device memory over N
// leaves and L lists: [0, N] the prefix of the leaves' chunk counts
// (chunks of CHUNK elements), [N+1, 2N] their element counts, then list l's
// N pointers at 2N+1 + lN. The wrapper (ops/multi_tensor.py) builds it on
// the host and copies it from pinned memory on the launch's stream, so the
// host never waits on the queue. Block b takes one chunk: it finds its leaf
// by a binary search of the prefix (empty leaves own no chunk).
//
// What bounds it on an H100: bytes. Each stage reads and writes every
// element of its lists once (Adamax: 3 reads, 3 writes, 24 bytes an
// element): at 246.7 M parameters a stage is 2-6 GB, 0.6-1.8 ms at
// 3.35 TB/s. Blocks of 256 threads and 16,384-element chunks keep enough
// independent loads in flight (4 a thread in each pass of the loop) to
// reach the card's bandwidth; the search costs a few cached loads a block.
//
// The arithmetic is PyTorch's, operation by operation, with the rounding
// written out (__fmul_rn, __fadd_rn, __fdiv_rn are never contracted into
// an FMA), so that each rule gives the bits of the per-leaf operators it
// replaces: rsqrtf and sqrtf are what PyTorch's CUDA rsqrt and sqrt call.
//
// Reductions (the guard's absmax and sum of squares) are deterministic: a
// fixed order inside a thread, a fixed shuffle and shared-memory tree in a
// block (one partial a chunk), then one thread a leaf sums or maxes its
// chunks' partials in order. No atomics, so two runs give the same bits.
// The absmax keeps NaN (as torch.max does): a leaf holding a NaN reads NaN.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;
constexpr int64_t kChunk = 16384;
constexpr int kReduceThreads = 1024;

struct Leaf {
  int index;
  int64_t begin, end;   // the block's element range in the leaf
};

__device__ __forceinline__ Leaf find_leaf(const int64_t* __restrict__ table, int n) {
  const int64_t chunk = blockIdx.x;
  int lo = 0, hi = n - 1;   // the last leaf whose first chunk is <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int64_t numel = table[n + 1 + lo];
  const int64_t begin = (chunk - table[lo]) * kChunk;
  return {lo, begin, begin + kChunk < numel ? begin + kChunk : numel};
}

template <typename T>
__device__ __forceinline__ T* list_ptr(const int64_t* __restrict__ table, int n, int list,
                                       int leaf) {
  return reinterpret_cast<T*>(table[2 * n + 1 + list * n + leaf]);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;   // NaN wins, as torch.max and torch.maximum
}

// ---- elementwise rules: kIn input lists, then kOut output lists --------------

struct SelectZeroOp {   // where(ok, x, 0), on 4-byte words (float32 or int32)
  using T = uint32_t;
  static constexpr int kIn = 1, kOut = 1;
  const bool* ok_p;
  bool ok;
  __device__ void setup() { ok = *ok_p; }
  __device__ void operator()(const T (&in)[kIn], T (&out)[kOut]) const {
    out[0] = ok ? in[0] : 0u;
  }
};

struct SelectOp {   // where(ok, a, b), on 4-byte words
  using T = uint32_t;
  static constexpr int kIn = 2, kOut = 1;
  const bool* ok_p;
  bool ok;
  __device__ void setup() { ok = *ok_p; }
  __device__ void operator()(const T (&in)[kIn], T (&out)[kOut]) const {
    out[0] = ok ? in[0] : in[1];
  }
};

struct ScaleOp {   // s * x: s a constant, or read from device memory
  using T = float;
  static constexpr int kIn = 1, kOut = 1;
  const float* s_p;
  float s;
  __device__ void setup() { if (s_p != nullptr) s = *s_p; }
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    out[0] = __fmul_rn(in[0], s);
  }
};

struct AxpyOp {   // x + a * y (add_decayed_weights: g + wd * p)
  using T = float;
  static constexpr int kIn = 2, kOut = 1;
  float a;
  __device__ void setup() {}
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    out[0] = __fadd_rn(in[0], __fmul_rn(a, in[1]));
  }
};

struct AddOp {   // apply_updates: p + u
  using T = float;
  static constexpr int kIn = 2, kOut = 1;
  __device__ void setup() {}
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    out[0] = __fadd_rn(in[0], in[1]);
  }
};

struct RssOp {   // scale_by_rss: s' = g*g + s; u = where(s' > 0, rsqrt(s' + eps), 0) * g
  using T = float;
  static constexpr int kIn = 2, kOut = 2;
  float eps;
  __device__ void setup() {}
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    const float g = in[0];
    const float s = __fadd_rn(__fmul_rn(g, g), in[1]);
    out[0] = __fmul_rn(s > 0.f ? rsqrtf(__fadd_rn(s, eps)) : 0.f, g);
    out[1] = s;
  }
};

struct RmsOp {   // scale_by_rms: nu' = (1-d)*(g*g) + d*nu; u = rsqrt(nu' + eps) * g
  using T = float;
  static constexpr int kIn = 2, kOut = 2;
  float one_minus_decay, decay, eps;
  __device__ void setup() {}
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    const float g = in[0];
    const float nu = __fadd_rn(__fmul_rn(one_minus_decay, __fmul_rn(g, g)),
                               __fmul_rn(decay, in[1]));
    out[0] = __fmul_rn(rsqrtf(__fadd_rn(nu, eps)), g);
    out[1] = nu;
  }
};

struct AdamOp {   // scale_by_adam: u = (mu'/c1) / (sqrt(nu'/c2) + eps)
  using T = float;
  static constexpr int kIn = 3, kOut = 3;
  float one_minus_b1, b1, one_minus_b2, b2, eps;
  const float* c1_p;
  const float* c2_p;
  float c1, c2;
  __device__ void setup() { c1 = *c1_p; c2 = *c2_p; }
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    const float g = in[0];
    const float mu = __fadd_rn(__fmul_rn(one_minus_b1, g), __fmul_rn(b1, in[1]));
    const float nu = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(g, g)),
                               __fmul_rn(b2, in[2]));
    out[0] = __fdiv_rn(__fdiv_rn(mu, c1), __fadd_rn(sqrtf(__fdiv_rn(nu, c2)), eps));
    out[1] = mu;
    out[2] = nu;
  }
};

struct AdamaxOp {   // scale_by_adamax: nu' = max(|g| + eps, b2*nu); u = (mu'/c1) / nu'
  using T = float;
  static constexpr int kIn = 3, kOut = 3;
  float one_minus_b1, b1, b2, eps;
  const float* c1_p;
  float c1;
  __device__ void setup() { c1 = *c1_p; }
  __device__ void operator()(const float (&in)[kIn], float (&out)[kOut]) const {
    const float g = in[0];
    const float mu = __fadd_rn(__fmul_rn(one_minus_b1, g), __fmul_rn(b1, in[1]));
    const float nu = nan_max(__fadd_rn(fabsf(g), eps), __fmul_rn(b2, in[2]));
    out[0] = __fdiv_rn(__fdiv_rn(mu, c1), nu);
    out[1] = mu;
    out[2] = nu;
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_apply(const int64_t* __restrict__ table, int n, Op op) {
  using T = typename Op::T;
  const Leaf leaf = find_leaf(table, n);
  const T* src[Op::kIn];
  T* dst[Op::kOut];
#pragma unroll
  for (int l = 0; l < Op::kIn; ++l) src[l] = list_ptr<const T>(table, n, l, leaf.index);
#pragma unroll
  for (int l = 0; l < Op::kOut; ++l) dst[l] = list_ptr<T>(table, n, Op::kIn + l, leaf.index);
  op.setup();
  for (int64_t base = leaf.begin + threadIdx.x; base < leaf.end;
       base += int64_t{kThreads} * kIlp) {
    T in[kIlp][Op::kIn];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < leaf.end) {
#pragma unroll
        for (int l = 0; l < Op::kIn; ++l) in[k][l] = src[l][i];
      }
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < leaf.end) {
        T out[Op::kOut];
        op(in[k], out);
#pragma unroll
        for (int l = 0; l < Op::kOut; ++l) dst[l][i] = out[l];
      }
    }
  }
}

// ---- the guard's reductions --------------------------------------------------

struct MaxAbs {
  static __device__ float identity() { return 0.f; }
  static __device__ float combine(float a, float b) { return nan_max(a, b); }
  static __device__ float term(float x, float) { return fabsf(x); }
};

struct SumSquares {   // sum of (x / scale)^2, scale read from device memory
  static __device__ float identity() { return 0.f; }
  static __device__ float combine(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float term(float x, float scale) {
    const float q = __fdiv_rn(x, scale);
    return __fmul_rn(q, q);
  }
};

// one partial a chunk: each thread folds its elements in index order, then
// a fixed shuffle tree a warp and a fixed tree over the warps
template <class R>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_chunk_reduce(const int64_t* __restrict__ table, int n,
                              const float* __restrict__ scale_p, float* __restrict__ partial) {
  const Leaf leaf = find_leaf(table, n);
  const float* x = list_ptr<const float>(table, n, 0, leaf.index);
  const float scale = scale_p != nullptr ? *scale_p : 1.f;
  float acc = R::identity();
  for (int64_t base = leaf.begin + threadIdx.x; base < leaf.end;
       base += int64_t{kThreads} * kIlp) {
    float v[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int64_t i = base + k * kThreads;
      v[k] = i < leaf.end ? R::term(x[i], scale) : R::identity();
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) acc = R::combine(acc, v[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = R::combine(acc, __shfl_down_sync(0xffffffffu, acc, o));
  __shared__ float warps[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warps[lane] : R::identity();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = R::combine(acc, __shfl_down_sync(0xffffffffu, acc, o));
    if (lane == 0) partial[blockIdx.x] = acc;
  }
}

// one thread a leaf folds its chunks' partials in order
template <class R>
__global__ void __launch_bounds__(kReduceThreads)
    multi_tensor_leaf_reduce(const int64_t* __restrict__ table, int n,
                             const float* __restrict__ partial, float* __restrict__ out) {
  for (int leaf = threadIdx.x; leaf < n; leaf += kReduceThreads) {
    float acc = R::identity();
    for (int64_t c = table[leaf]; c < table[leaf + 1]; ++c) acc = R::combine(acc, partial[c]);
    out[leaf] = acc;
  }
}

template <class Op>
int apply(const int64_t* table, int n, int64_t chunks, Op op, void* stream) {
  if (chunks == 0) return 0;
  multi_tensor_apply<Op><<<static_cast<unsigned>(chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(table, n, op);
  return static_cast<int>(cudaGetLastError());
}

template <class R>
int reduce(const int64_t* table, int n, int64_t chunks, const float* scale, float* partial,
           float* out, void* stream) {
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    multi_tensor_chunk_reduce<R><<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(
        table, n, scale, partial);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  multi_tensor_leaf_reduce<R><<<1, kReduceThreads, 0, s>>>(table, n, partial, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: (table, n leaves, chunks, the rule's scalars, stream);
// returns cudaGetLastError() after its launches.

extern "C" int wst_mt_select(const int64_t* table, int n, int64_t chunks, const bool* ok,
                             int with_other, void* stream) {
  if (with_other) return apply(table, n, chunks, SelectOp{ok, false}, stream);
  return apply(table, n, chunks, SelectZeroOp{ok, false}, stream);
}

extern "C" int wst_mt_scale(const int64_t* table, int n, int64_t chunks, const float* s_p,
                            float s, void* stream) {
  return apply(table, n, chunks, ScaleOp{s_p, s}, stream);
}

extern "C" int wst_mt_axpy(const int64_t* table, int n, int64_t chunks, float a,
                           void* stream) {
  return apply(table, n, chunks, AxpyOp{a}, stream);
}

extern "C" int wst_mt_add(const int64_t* table, int n, int64_t chunks, void* stream) {
  return apply(table, n, chunks, AddOp{}, stream);
}

extern "C" int wst_mt_rss(const int64_t* table, int n, int64_t chunks, float eps,
                          void* stream) {
  return apply(table, n, chunks, RssOp{eps}, stream);
}

extern "C" int wst_mt_rms(const int64_t* table, int n, int64_t chunks, float one_minus_decay,
                          float decay, float eps, void* stream) {
  return apply(table, n, chunks, RmsOp{one_minus_decay, decay, eps}, stream);
}

extern "C" int wst_mt_adam(const int64_t* table, int n, int64_t chunks, float one_minus_b1,
                           float b1, float one_minus_b2, float b2, float eps, const float* c1,
                           const float* c2, void* stream) {
  return apply(table, n, chunks,
               AdamOp{one_minus_b1, b1, one_minus_b2, b2, eps, c1, c2, 0.f, 0.f}, stream);
}

extern "C" int wst_mt_adamax(const int64_t* table, int n, int64_t chunks, float one_minus_b1,
                             float b1, float b2, float eps, const float* c1, void* stream) {
  return apply(table, n, chunks, AdamaxOp{one_minus_b1, b1, b2, eps, c1, 0.f}, stream);
}

extern "C" int wst_mt_absmax(const int64_t* table, int n, int64_t chunks, float* partial,
                             float* out, void* stream) {
  return reduce<MaxAbs>(table, n, chunks, nullptr, partial, out, stream);
}

extern "C" int wst_mt_sum_squares(const int64_t* table, int n, int64_t chunks,
                                  const float* scale, float* partial, float* out,
                                  void* stream) {
  return reduce<SumSquares>(table, n, chunks, scale, partial, out, stream);
}
