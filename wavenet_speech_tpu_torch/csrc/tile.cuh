// Tile helpers shared by the fused block's forward (fused_block.cu) and
// backward (fused_block_bwd.cu). A block of NT threads computes a TL-row by
// CH-channel tile of a product (or two tiles side by side), each thread a
// 4-row x 4-channel register tile, streaming the reduction dimension through
// shared memory KC deep: rows of activations transposed into As (KC, AS),
// rows of weights into Bs (KC, BS).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KC = 16;   // reduction depth per shared-memory stage
// RG row groups of 4 rows by CG channel groups of 4 channels; CH channels a
// tile; AS row stride of the transposed (k, row) tiles; BS row stride of the
// weight tile (two tiles of CH).
constexpr int TL = 32;
constexpr int RG = TL / 4;
constexpr int CG = NT / RG;
constexpr int CH = CG * 4;
constexpr int AS = TL + 4;
constexpr int BS = 2 * CH;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// As[k][r] = M[row0 + r][c0 + k], zero outside rows [0, L) and columns
// [0, ncols). M is row-major and stored as two column blocks: columns
// [0, split) are the rows of p0 (row length split), columns [split, ncols)
// the rows of p1 (row length ncols - split). One block: p1 = p0,
// split = ncols. Needs split and ncols divisible by 4.
__device__ __forceinline__ void load_rows_t(float* As, const float* __restrict__ p0,
                                            const float* __restrict__ p1, int split,
                                            int row0, int c0, int L, int ncols) {
  if (threadIdx.x >= TL * (KC / 4)) return;
  const int r = threadIdx.x >> 2;
  const int cg = (threadIdx.x & 3) * 4;
  const int t = row0 + r;
  const int c = c0 + cg;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t >= 0 && t < L && c < ncols)
    v = c < split ? *reinterpret_cast<const float4*>(p0 + (size_t)t * split + c)
                  : *reinterpret_cast<const float4*>(p1 + (size_t)t * (ncols - split) +
                                                     (c - split));
  As[(cg + 0) * AS + r] = v.x;
  As[(cg + 1) * AS + r] = v.y;
  As[(cg + 2) * AS + r] = v.z;
  As[(cg + 3) * AS + r] = v.w;
}

// Bs[k][j] = w[k0 + k][col_a + j] for j < n_a, Bs[k][CH + j] =
// w[k0 + k][col_b + j] for j < n_b (second tile only if TWO), zero
// elsewhere and where k0 + k >= k_max. w is row-major with row length ld.
template <bool TWO>
__device__ __forceinline__ void load_w_tile(float* Bs, const float* __restrict__ w, int ld,
                                            int k0, int k_max, int col_a, int col_b,
                                            int n_a, int n_b) {
  for (int i = threadIdx.x; i < KC * (CH / 4); i += NT) {
    const int k = i / (CH / 4);
    const int j = (i % (CH / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = a;
    if (k0 + k < k_max) {
      const float* row = w + (size_t)(k0 + k) * ld;
      if (j < n_a) a = *reinterpret_cast<const float4*>(row + col_a + j);
      if (TWO && j < n_b) b = *reinterpret_cast<const float4*>(row + col_b + j);
    }
    *reinterpret_cast<float4*>(Bs + k * BS + j) = a;
    *reinterpret_cast<float4*>(Bs + k * BS + CH + j) = b;
  }
}

// acc0[i][j] += sum_k A[k][ty*4+i] * Bs[k][tx*4+j]; acc1 likewise with the
// second tile of Bs (if TWO). A is a transposed tile with row stride AS.
template <bool TWO>
__device__ __forceinline__ void tile_fma(float (&acc0)[4][4], float (&acc1)[4][4],
                                         const float* A, const float* Bs, int tx, int ty) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * AS + ty * 4);
    const float4 u = *reinterpret_cast<const float4*>(Bs + k * BS + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc0[i][j] = fmaf(av[i], uv[j], acc0[i][j]);
    if (TWO) {
      const float4 v = *reinterpret_cast<const float4*>(Bs + k * BS + CH + tx * 4);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(av[i], vv[j], acc1[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

}  // namespace
