// The warps that hold one read's band in the realign, Viterbi and
// forward-only kernels (csrc/realign.cu, csrc/viterbi.cu,
// csrc/forward.cu): G = 1 warp up to W = 128, G = 2 at W = 256, 3 at
// W = 384, 4 at W = 512, 6 at W = 768 and 8 at W = 1024, warp wg of the
// group owning band cells 32 C wg .. 32 C (wg + 1) - 1, lane l of it C
// adjacent cells.
//
// Across the seam between two warps, values pass through a small shared
// buffer of two alternating halves, x[2][G][2][N] words (per warp: its
// lane 0's words, then its lane 31's, at most N each), and one named
// barrier (id `bar`, the group's 32 G threads) an exchange.  An exchange
// writes the half that the one before it did not, so one barrier an
// exchange orders both the reads of the last and the writes of the next.
// At G = 1 the group is one warp and no exchange is made (the callers
// test G at compile time), so the W <= 128 builds are those of one warp
// a read.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grp {

template <int G, int N>
struct Group {
  int lane;     // lane in its warp
  int wg;       // warp in the group
  int gl;       // lane in the group: wg * 32 + lane
  int bar;      // named barrier id (G > 1)
  uint32_t* x;  // the group's exchange buffer, buffer_words<G, N>() words (G > 1)
  int ph;       // the half the next exchange writes
};

// Words a group's exchange buffer takes
template <int G, int N>
__host__ __device__ constexpr int buffer_words() {
  return 2 * G * 2 * N;
}

// reads a block of the Viterbi and forward-only kernels: two of one
// warp, or one group of G warps
__host__ __device__ constexpr int reads_per_block(int G) { return G == 1 ? 2 : 1; }

// The group of block warp `warp` (G consecutive warps a group), with
// named barrier `bar` and exchange buffer `x`
template <int G, int N>
__device__ __forceinline__ Group<G, N> make(int warp, int bar, uint32_t* x) {
  const int lane = threadIdx.x & 31;
  const int wg = G == 1 ? 0 : warp % G;
  return Group<G, N>{lane, wg, wg * 32 + lane, bar, x, 0};
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// the group's barrier: __syncwarp for one warp
template <int G, int N>
__device__ __forceinline__ void sync(const Group<G, N>& g) {
  if constexpr (G == 1)
    __syncwarp();
  else
    bar_sync(g.bar, 32 * G);
}

// The words across the seams (G > 1), M <= N of them (T: any 4-byte
// type): lane 0 of each warp gives `bottom` (from its first cells),
// lane 31 `top` (from its last cells); every lane gets in hi[i] the
// next warp's bottom[i] (fill[i] in the group's top warp) and in lo[i]
// the previous warp's top[i] (fill[i] in warp 0).
template <typename T, int M, int G, int N>
__device__ __forceinline__ void exchange(Group<G, N>& g, const T (&bottom)[M],
                                         const T (&top)[M], const T (&fill)[M], T (&hi)[M],
                                         T (&lo)[M]) {
  static_assert(G > 1, "one warp has no seam");
  static_assert(M <= N && sizeof(T) == 4, "at most N words a warp edge");
  T* x = reinterpret_cast<T*>(g.x) + g.ph * (G * 2 * N);
  if (g.lane == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) x[(g.wg * 2) * N + i] = bottom[i];
  } else if (g.lane == 31) {
#pragma unroll
    for (int i = 0; i < M; ++i) x[(g.wg * 2 + 1) * N + i] = top[i];
  }
  bar_sync(g.bar, 32 * G);
  const bool is_top = g.wg == G - 1, is_bottom = g.wg == 0;
  const int above = is_top ? g.wg : g.wg + 1, below = is_bottom ? g.wg : g.wg - 1;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    hi[i] = is_top ? fill[i] : x[(above * 2) * N + i];
    lo[i] = is_bottom ? fill[i] : x[(below * 2 + 1) * N + i];
  }
  g.ph ^= 1;
}

// The maximum over the group of a warp-uniform int (signed order)
template <int G, int N>
__device__ __forceinline__ int max(Group<G, N>& g, int v) {
  if constexpr (G > 1) {
    int* x = reinterpret_cast<int*>(g.x) + g.ph * (G * 2 * N);
    if (g.lane == 0) x[g.wg * 2 * N] = v;
    bar_sync(g.bar, 32 * G);
#pragma unroll
    for (int j = 0; j < G; ++j) v = ::max(v, x[j * 2 * N]);
    g.ph ^= 1;
  }
  return v;
}

// group lane 0's value to every lane of the group (every lane calls;
// T: any 4-byte type that __shfl_sync takes)
template <typename T, int G, int N>
__device__ __forceinline__ T from_lane0(Group<G, N>& g, T v) {
  v = __shfl_sync(0xffffffffu, v, 0);
  if constexpr (G > 1) {
    T* x = reinterpret_cast<T*>(g.x) + g.ph * (G * 2 * N);
    if (g.gl == 0) x[0] = v;
    bar_sync(g.bar, 32 * G);
    v = x[0];
    g.ph ^= 1;
  }
  return v;
}

}  // namespace grp
