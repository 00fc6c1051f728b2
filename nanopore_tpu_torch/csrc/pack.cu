// Pack kernel: builds the packed band codes of a realign batch on the card.
//
// Replaces nanopore_tpu/ops/pack_pallas.py::_pack_kernel (the TPU's
// on-device band build).  Per read the host streams one byte per
// diagonal (bits 0-2 the symbol entering the band, bit 6 d1[k], bit 7
// d1[k-1]) and a W-symbol seed of the x window; this kernel integrates
// the band offset o[k] from bit 6, slides the x window up (d1 = 1) or the
// y window down (d1 = 0) by the entering symbol, recomputes each cell's
// validity from (k, o[k], w, m, n) and writes
//     xyc[r][k-1][w] = x*8 + y | bit 6 d1[k] | bit 7 d1[k-1]
// with sentinel 5 for x or y outside the lattice.  Byte for byte the
// output of the plain version in ops/pack.py and of the TPU kernel.
//
// Bound: bytes.  It reads 1 byte and writes W bytes per diagonal per
// read and does a handful of integer operations per written byte.
// Design: one warp per read (independent reads, no inter-block
// communication); each lane owns C = W/32 adjacent band cells and keeps
// its part of both windows in registers, so the one-symbol slide is a
// single warp shuffle.  The stream is read 32 diagonals at a time, one
// coalesced byte per lane, and broadcast by shuffle; each diagonal's row
// is written as one coalesced W-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 2;  // reads per block

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
pack_kernel(const uint8_t* __restrict__ stream, const uint8_t* __restrict__ initx,
            const int32_t* __restrict__ m, const int32_t* __restrict__ n,
            int nreads, int k_pad, uint8_t* __restrict__ xyc) {
  constexpr int W = 32 * C;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= nreads) return;
  const int w0 = lane * C;
  const int mr = m[r];
  const int nr = n[r];
  const uint8_t* st = stream + (size_t)r * k_pad;
  uint8_t* out = xyc + (size_t)r * k_pad * W;

  int xw[C], yw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    xw[c] = initx[(size_t)r * W + w0 + c];
    yw[c] = 5;
  }
  int o = 0;
  for (int k0 = 0; k0 < k_pad; k0 += 32) {
    const int mine = st[k0 + lane];
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const int byte = __shfl_sync(FULL, mine, t);
      const int d1 = (byte >> 6) & 1;
      const int ent = byte & 7;
      const int top = byte & 0xC0;
      if (d1) {  // x window slides up, the new symbol enters at w = W-1
        const int nb = __shfl_down_sync(FULL, xw[0], 1);
#pragma unroll
        for (int c = 0; c < C - 1; ++c) xw[c] = xw[c + 1];
        xw[C - 1] = lane == 31 ? ent : nb;
      } else {  // y window slides down, the new symbol enters at w = 0
        const int nb = __shfl_up_sync(FULL, yw[C - 1], 1);
#pragma unroll
        for (int c = C - 1; c > 0; --c) yw[c] = yw[c - 1];
        yw[0] = lane == 0 ? ent : nb;
      }
      o += d1;
      const int k = k0 + t + 1;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = o + w0 + c;
        const int i = k - j;
        const bool ok = j <= nr && i >= 0 && i <= mr;
        const int xv = (ok && j >= 1) ? xw[c] : 5;
        const int yv = (ok && i >= 1) ? yw[c] : 5;
        word |= (uint32_t)((xv * 8 + yv + top) & 0xFF) << (8 * c);
      }
      uint8_t* row = out + (size_t)(k - 1) * W + w0;
      if constexpr (C == 2) {
        *reinterpret_cast<uint16_t*>(row) = (uint16_t)word;
      } else {
        *row = (uint8_t)word;
      }
    }
  }
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int np_pack_launch(const void* stream_bytes, const void* initx,
                              const void* m, const void* n, int nreads,
                              int k_pad, int W, void* xyc, void* stream) {
  if (nreads <= 0 || k_pad % 32 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((nreads + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sb = (const uint8_t*)stream_bytes;
  const uint8_t* ix = (const uint8_t*)initx;
  const int32_t* mm = (const int32_t*)m;
  const int32_t* nn = (const int32_t*)n;
  uint8_t* out = (uint8_t*)xyc;
  if (W == 64) {
    pack_kernel<2><<<grid, block, 0, s>>>(sb, ix, mm, nn, nreads, k_pad, out);
  } else if (W == 32) {
    pack_kernel<1><<<grid, block, 0, s>>>(sb, ix, mm, nn, nreads, k_pad, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
