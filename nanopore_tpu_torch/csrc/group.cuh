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
//
// The cluster tier (CB > 1: W = 1536 and 2048 in the realign kernel):
// a read's band is held by a thread-block cluster of CB blocks, one an
// SM, each of one group of G warps, so the band has CB G warps and warp
// wg of the read is the block's cluster rank x G + its warp in the
// block.  Each block keeps its own exchange buffer, indexed by the warp
// in the block; the barrier is the cluster's (barrier.cluster arrive
// with release, wait with acquire: every thread of the cluster), after
// which a block's bottom warp reads the top warp of rank - 1 and its top
// warp the bottom warp of rank + 1 through distributed shared memory
// (mapa, ld.shared::cluster).  The two halves alternate as in one block,
// so one cluster barrier an exchange still orders the reads of the last
// and the writes of the next.  The band maximum and group lane 0's
// broadcast take the same route, and sync() is the cluster barrier.
// Every CB > 1 branch is behind `if constexpr`: at CB = 1 the code is
// that of one block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grp {

template <int G, int N, int CB = 1>
struct Group {
  int lane;     // lane in its warp
  int wg;       // warp in the group (the read's: rank * G + warp in the block)
  int gl;       // lane in the group: wg * 32 + lane
  int bar;      // named barrier id (G > 1, CB = 1)
  uint32_t* x;  // the block's exchange buffer, buffer_words<G, N>() words (G > 1)
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

// the block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The group of block warp `warp` (G consecutive warps a group), with
// named barrier `bar` and exchange buffer `x`; at CB > 1 the block's
// group is the one of its cluster rank in the read's CB G warps
template <int G, int N, int CB = 1>
__device__ __forceinline__ Group<G, N, CB> make(int warp, int bar, uint32_t* x) {
  const int lane = threadIdx.x & 31;
  if constexpr (CB == 1) {
    const int wg = G == 1 ? 0 : warp % G;
    return Group<G, N, CB>{lane, wg, wg * 32 + lane, bar, x, 0};
  } else {
    const int wg = cluster_rank() * G + warp % G;
    return Group<G, N, CB>{lane, wg, wg * 32 + lane, bar, x, 0};
  }
}

// the group's block's rank in its cluster (0 at CB = 1)
template <int G, int N, int CB>
__device__ __forceinline__ int rank(const Group<G, N, CB>& g) {
  if constexpr (CB == 1)
    return 0;
  else
    return g.wg / G;
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// the cluster's barrier: every thread of every block of the cluster
// arrives (release: its earlier memory accesses are ordered before) and
// waits (acquire: the others' are visible after)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the 4-byte word at shared address p of this block, read in the block
// of cluster rank `rank` (distributed shared memory)
template <typename T>
__device__ __forceinline__ T remote_load(const T* p, int rank) {
  static_assert(sizeof(T) == 4, "a 4-byte word");
  const unsigned local = (unsigned)__cvta_generic_to_shared(p);
  unsigned addr, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  T out;
  __builtin_memcpy(&out, &v, 4);
  return out;
}

// the group's barrier: __syncwarp for one warp, the cluster's at CB > 1
template <int G, int N, int CB>
__device__ __forceinline__ void sync(const Group<G, N, CB>& g) {
  if constexpr (G == 1)
    __syncwarp();
  else if constexpr (CB > 1)
    cluster_sync();
  else
    bar_sync(g.bar, 32 * G);
}

// The words across the seams (G > 1), M <= N of them (T: any 4-byte
// type): lane 0 of each warp gives `bottom` (from its first cells),
// lane 31 `top` (from its last cells); every lane gets in hi[i] the
// next warp's bottom[i] (fill[i] in the group's top warp) and in lo[i]
// the previous warp's top[i] (fill[i] in warp 0).  At CB > 1 the warps
// are the cluster's, the next warp of a block's top warp the bottom warp
// of rank + 1.
template <typename T, int M, int G, int N, int CB>
__device__ __forceinline__ void exchange(Group<G, N, CB>& g, const T (&bottom)[M],
                                         const T (&top)[M], const T (&fill)[M], T (&hi)[M],
                                         T (&lo)[M]) {
  static_assert(G > 1, "one warp has no seam");
  static_assert(M <= N && sizeof(T) == 4, "at most N words a warp edge");
  T* x = reinterpret_cast<T*>(g.x) + g.ph * (G * 2 * N);
  if constexpr (CB == 1) {
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
  } else {
    const int rk = rank(g), wb = g.wg - rk * G;  // the block's rank, the warp in it
    if (g.lane == 0) {
#pragma unroll
      for (int i = 0; i < M; ++i) x[(wb * 2) * N + i] = bottom[i];
    } else if (g.lane == 31) {
#pragma unroll
      for (int i = 0; i < M; ++i) x[(wb * 2 + 1) * N + i] = top[i];
    }
    cluster_sync();
    // the block's top warp reads rank + 1's warp 0, its warp 0 rank - 1's
    // top warp; the band's top and bottom warps take the fill
    const bool up_out = wb == G - 1, down_out = wb == 0;
    const bool is_top = up_out && rk == CB - 1, is_bottom = down_out && rk == 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      hi[i] = is_top     ? fill[i]
              : up_out   ? remote_load(x + i, rk + 1)
                         : x[((wb + 1) * 2) * N + i];
      lo[i] = is_bottom  ? fill[i]
              : down_out ? remote_load(x + ((G - 1) * 2 + 1) * N + i, rk - 1)
                         : x[((wb - 1) * 2 + 1) * N + i];
    }
  }
  g.ph ^= 1;
}

// The maximum over the group of a warp-uniform int (signed order)
template <int G, int N, int CB>
__device__ __forceinline__ int max(Group<G, N, CB>& g, int v) {
  if constexpr (G > 1) {
    int* x = reinterpret_cast<int*>(g.x) + g.ph * (G * 2 * N);
    if constexpr (CB == 1) {
      if (g.lane == 0) x[g.wg * 2 * N] = v;
      bar_sync(g.bar, 32 * G);
#pragma unroll
      for (int j = 0; j < G; ++j) v = ::max(v, x[j * 2 * N]);
    } else {
      const int rk = rank(g);
      if (g.lane == 0) x[(g.wg - rk * G) * 2 * N] = v;
      cluster_sync();
#pragma unroll
      for (int j = 0; j < G; ++j) v = ::max(v, x[j * 2 * N]);
#pragma unroll
      for (int b = 1; b < CB; ++b) {
        const int other = (rk + b) % CB;
#pragma unroll
        for (int j = 0; j < G; ++j) v = ::max(v, remote_load(x + j * 2 * N, other));
      }
    }
    g.ph ^= 1;
  }
  return v;
}

// group lane 0's value to every lane of the group (every lane calls;
// T: any 4-byte type that __shfl_sync takes)
template <typename T, int G, int N, int CB>
__device__ __forceinline__ T from_lane0(Group<G, N, CB>& g, T v) {
  v = __shfl_sync(0xffffffffu, v, 0);
  if constexpr (G > 1) {
    T* x = reinterpret_cast<T*>(g.x) + g.ph * (G * 2 * N);
    if (g.gl == 0) x[0] = v;
    if constexpr (CB == 1) {
      bar_sync(g.bar, 32 * G);
      v = x[0];
    } else {  // rank 0's word
      cluster_sync();
      v = rank(g) == 0 ? x[0] : remote_load(x, 0);
    }
    g.ph ^= 1;
  }
  return v;
}

}  // namespace grp
