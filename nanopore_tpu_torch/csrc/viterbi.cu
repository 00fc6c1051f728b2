// Banded five-state Viterbi: the max-product forward over packed band
// codes, one backpointer byte per band cell per diagonal.
//
// Replaces nanopore_tpu/ops/pairhmm_pallas_viterbi.py::_viterbi_kernel.
// Log space, no rescaling.  Per diagonal k and destination state, the
// max and argmax over the 5 predecessor states (pred + ltf[s*5 + dest],
// a tie keeps the lower state) are taken before the band shift (match
// from diagonal k-2 by d2, deletes from k-1 by d1 - 1, inserts from k-1
// by d1; NEG and backpointer 0 shifted in), then the emission is added
// and the sum clamped at NEG.  A cell whose x or y code is the sentinel
// 5 emits NEG; N = 4 is a real code.  The backpointer byte is
// p = bM + 5 * (tD1 + 2 tI1 + 4 tD2 + 8 tI2), the gap states collapsed
// to from-self bits (the canonical fiveState structure, checked by the
// wrapper).  At band cell 0 of diagonal k_end = m + n the score and its
// argmax state (strict >) are captured.  The arithmetic is the plain
// version's in ops/viterbi.py, in its order: adds and maxima only, so
// the two agree to the bit.
//
// Bound: operations.  About 100 operations per band cell per diagonal
// (25 adds, 20 compares, 20 maxima and 20 argmax selects for the
// predecessors; 5 validity selects, 5 adds and 5 maxima for the
// emissions) against one code byte in and one backpointer byte out; the
// recursion is a serial chain over ~10^4 diagonals per read.  Design:
// the realign kernel's (csrc/realign.cu): one warp per read, each lane owning
// C = W/32 adjacent band cells in registers, so a band shift is one warp
// shuffle; reads are independent, so hundreds of warps fill the card and
// hide each other's latency.  The 91 log floats sit in shared memory.
// The codes of the next diagonal are loaded before the current one is
// computed; the warp writes one W-byte backpointer row per diagonal,
// coalesced.  A read stops at its own end diagonal and zeroes the rows
// above it.  All 5 predecessors of every state are computed, as the TPU
// kernel does; the canonical structure needs 2 for a gap state (later
// speed work).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 5;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 2;  // reads per block
constexpr int NTAB = 91;  // ltf 25 | lemf 36 | legf 30

struct Tables {
  float v[NTAB];
};

// out[w] = a[w + s] for a warp-uniform s in {-1, 0, 1}; `fill` outside.
template <int C, typename T>
__device__ __forceinline__ void shift(const T (&a)[C], T (&o)[C], int s, T fill,
                                      int lane) {
  if (s == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = a[c];
  } else if (s > 0) {
    const T nb = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) o[c] = a[c + 1];
    o[C - 1] = lane == 31 ? fill : nb;
  } else {
    const T nb = __shfl_up_sync(FULL, a[C - 1], 1);
#pragma unroll
    for (int c = C - 1; c > 0; --c) o[c] = a[c - 1];
    o[0] = lane == 0 ? fill : nb;
  }
}

// max / argmax over the 5 predecessor states for destination `dest`
template <int C>
__device__ __forceinline__ void best(const float* ltf, const float (&p)[NS][C],
                                     int dest, float (&v)[C], int (&b)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float bv = p[0][c] + ltf[dest];
    int bs = 0;
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      const float cand = p[s][c] + ltf[s * 5 + dest];
      if (cand > bv) bs = s;
      bv = fmaxf(bv, cand);
    }
    v[c] = bv;
    b[c] = bs;
  }
}

template <int C>
__device__ __forceinline__ void load_codes(const uint8_t* row, int w0, uint8_t (&c)[C]) {
  if constexpr (C == 2) {
    const uint16_t v = *reinterpret_cast<const uint16_t*>(row + w0);
    c[0] = (uint8_t)(v & 0xFF);
    c[C - 1] = (uint8_t)(v >> 8);
  } else {
    c[0] = row[w0];
  }
}

template <int C>
__device__ __forceinline__ void store_row(int8_t* row, int w0, uint32_t word) {
  if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(row + w0) = (uint16_t)word;
  } else {
    row[w0] = (int8_t)word;
  }
}

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(Tables tab, const uint8_t* __restrict__ xyc,
               const int32_t* __restrict__ m, const int32_t* __restrict__ n,
               int nreads, int k_pad, float* __restrict__ score,
               int32_t* __restrict__ fstate, int8_t* __restrict__ bp) {
  constexpr int W = 32 * C;
  __shared__ float sm[NTAB];
  for (int i = threadIdx.x; i < NTAB; i += blockDim.x) sm[i] = tab.v[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= nreads) return;
  const float* ltf = sm;
  const float* lemf = sm + 25;
  const float* legf = sm + 61;
  const int w0 = lane * C;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  int8_t* out = bp + (size_t)r * (k_pad + 1) * W;   // row k: diagonal k
  const int kend = m[r] + n[r];
  const int klast = kend < k_pad ? kend : k_pad;

  float a[NS][C], b[NS][C];  // diagonals k-1 and k-2
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // float32(log(1/5)), as the plain version rounds it
      a[s][c] = (w0 + c == 0) ? -1.6094379425048828f : NEG;
      b[s][c] = NEG;
    }
  store_row<C>(out, w0, 0u);
  float sc = NEG;
  int fs = 0;
  uint8_t cur[C];
  if (klast >= 1) load_codes<C>(xy, w0, cur);
  for (int k = 1; k <= klast; ++k) {
    uint8_t nxt[C];
    if (k < klast) {
      load_codes<C>(xy + (size_t)k * W, w0, nxt);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) nxt[c] = 0;
    }
    const int top = __shfl_sync(FULL, (int)cur[0], 0);
    const int d1 = (top >> 6) & 1;
    const int d2 = d1 + ((top >> 7) & 1) - 1;

    float v[NS][C], vs[NS][C];
    int bi[NS][C], bs[NS][C];
    best<C>(ltf, b, 0, v[0], bi[0]);
#pragma unroll
    for (int d = 1; d < NS; ++d) best<C>(ltf, a, d, v[d], bi[d]);
    shift<C, float>(v[0], vs[0], d2, NEG, lane);
    shift<C, int>(bi[0], bs[0], d2, 0, lane);
    shift<C, float>(v[1], vs[1], d1 - 1, NEG, lane);
    shift<C, int>(bi[1], bs[1], d1 - 1, 0, lane);
    shift<C, float>(v[2], vs[2], d1, NEG, lane);
    shift<C, int>(bi[2], bs[2], d1, 0, lane);
    shift<C, float>(v[3], vs[3], d1 - 1, NEG, lane);
    shift<C, int>(bi[3], bs[3], d1 - 1, 0, lane);
    shift<C, float>(v[4], vs[4], d1, NEG, lane);
    shift<C, int>(bi[4], bs[4], d1, 0, lane);

    float nw[NS][C];
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int x = (cur[c] >> 3) & 7;
      const int y = cur[c] & 7;
      const bool okx = x < 5, oky = y < 5;
      const float em = (okx && oky) ? lemf[x * 6 + y] : NEG;
      const float gx1 = okx ? legf[6 + x] : NEG;
      const float gy2 = oky ? legf[12 + y] : NEG;
      const float gx3 = okx ? legf[18 + x] : NEG;
      const float gy4 = oky ? legf[24 + y] : NEG;
      nw[0][c] = fmaxf(vs[0][c] + em, NEG);
      nw[1][c] = fmaxf(vs[1][c] + gx1, NEG);
      nw[2][c] = fmaxf(vs[2][c] + gy2, NEG);
      nw[3][c] = fmaxf(vs[3][c] + gx3, NEG);
      nw[4][c] = fmaxf(vs[4][c] + gy4, NEG);
      const int p = bs[0][c] + 5 * ((bs[1][c] != 0) + 2 * (bs[2][c] != 0) +
                                    4 * (bs[3][c] != 0) + 8 * (bs[4][c] != 0));
      word |= (uint32_t)p << (8 * c);
    }
    store_row<C>(out + (size_t)k * W, w0, word);
    if (k == kend && lane == 0) {  // cell (m, n): band cell 0
      float ve = nw[0][0];
      int se = 0;
#pragma unroll
      for (int s = 1; s < NS; ++s) {
        if (nw[s][0] > ve) se = s;
        ve = fmaxf(ve, nw[s][0]);
      }
      sc = ve;
      fs = se;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        b[s][c] = a[s][c];
        a[s][c] = nw[s][c];
      }
#pragma unroll
    for (int c = 0; c < C; ++c) cur[c] = nxt[c];
  }
  // the rows past the read's end diagonal are not part of its lattice
  for (int k = klast + 1; k <= k_pad; ++k) store_row<C>(out + (size_t)k * W, w0, 0u);
  if (lane == 0) {
    score[r] = sc;
    fstate[r] = fs;
  }
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `tables` is host memory: the 91 log floats of ops/viterbi.py.
extern "C" int np_viterbi_launch(const float* tables, const void* xyc, const void* m,
                                 const void* n, int nreads, int k_pad, int W,
                                 void* score, void* fstate, void* bp, void* stream) {
  if (nreads <= 0 || k_pad < 1) return (int)cudaErrorInvalidValue;
  Tables t;
  for (int i = 0; i < NTAB; ++i) t.v[i] = tables[i];
  const dim3 grid((nreads + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 64) {
    viterbi_kernel<2><<<grid, block, 0, s>>>(
        t, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n, nreads, k_pad,
        (float*)score, (int32_t*)fstate, (int8_t*)bp);
  } else if (W == 32) {
    viterbi_kernel<1><<<grid, block, 0, s>>>(
        t, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n, nreads, k_pad,
        (float*)score, (int32_t*)fstate, (int8_t*)bp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
