// Pack kernel: builds the packed band codes of a realign batch on the card.
//
// Replaces nanopore_tpu/ops/pack_pallas.py::_pack_kernel (the TPU's
// on-device band build).  Per read the host streams one byte per
// diagonal (bits 0-2 the symbol entering the band, bit 6 d1[k], bit 7
// d1[k-1]) and a W-symbol seed of the x window; the kernel writes
//     xyc[r][k-1][w] = x*8 + y | bit 6 d1[k] | bit 7 d1[k-1]
// with sentinel 5 for x or y outside the lattice, and in lanes at and
// above the live width wl <= W (a narrower band laid into the W-lane
// layout: its dead lanes emit nothing downstream).  Byte for byte the
// output of the plain version in ops/pack.py and, at wl = W, of the TPU
// kernel.
//
// Bound: bytes.  It reads 1 byte and writes W bytes per diagonal per
// read and does a handful of integer operations per written byte.
//
// Design: the windows are a pure function of the stream, so no diagonal
// waits for the one before it.  With o_k the band offset (the inclusive
// prefix sum of bit 6) and c_k = k - o_k,
//     xwin_k[w] = X[o_k + w],   X = initx, then the symbol of each d1 = 1
//                               diagonal, in order (X[W - 1 + o_k]);
//     ywin_k[w] = Y[c_k - w],   Y[t] the symbol of the t-th d1 = 0
//                               diagonal (read only where t >= 1),
// for any byte stream, valid or not.  One block of 128 threads per read
// walks its stream in chunks of 256 diagonals.  Per chunk: the stream
// bytes are loaded coalesced; one block-wide scan of bit 6, carried
// across chunks, gives o_k; each entering symbol is scattered into a
// linear shared-memory buffer of X (positions X[o_base ..]) or, reversed
// so that a row reads it ascending, of Y, each buffer headed by the last
// W symbols of the chunks before (two buffers of each, alternating by
// chunk); then every thread builds 16 cells of a row from two runs of 16
// buffer bytes and stores them as one 16-byte word, neighbouring threads
// on neighbouring words.  Two block barriers a chunk; the kernel is
// bound by its stores.  At W = 384 to 2048 a head of W symbols reaches
// back past the chunk before (at 1024 four chunks back, at 2048 eight):
// it is copied from the last chunk's buffer, whose own head held the W
// symbols before that chunk, so every window's lookup stays inside what
// the two buffers keep (CHUNK + W bytes each).  At W = 1024 a row is 64
// threads' 16 cells, so a pass of the block builds two rows; at 2048 a
// row is the block's 128 threads' 16 cells, one row a pass (1536: 96
// threads').
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int CHUNK = 2 * THREADS;  // diagonals a chunk: two a thread in the scan
constexpr int CELLS = 16;           // band cells a thread builds per row (one 16-byte store)

template <int W>
struct Smem {
  uint8_t xb[2][CHUNK + W];  // X[o_base + p] at p
  uint8_t yb[2][CHUNK + W];  // Y[c_base + CHUNK - p] at p
  uint8_t sb[CHUNK];         // the chunk's stream bytes
  int ok[CHUNK];             // the chunk's band offsets o_k
  int wsum[THREADS / 32];    // the scan's warp totals
};

template <int W>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const uint8_t* __restrict__ stream, const uint8_t* __restrict__ initx,
            const int32_t* __restrict__ m, const int32_t* __restrict__ n, int k_pad,
            int wl, uint8_t* __restrict__ xyc) {
  __shared__ __align__(16) Smem<W> sm;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int r = blockIdx.x;
  const int mr = m[r];
  const int nr = n[r];
  const uint8_t* st = stream + (size_t)r * k_pad;
  uint8_t* out = xyc + (size_t)r * k_pad * W;
  for (int i = t; i < W; i += THREADS) sm.xb[0][i] = initx[(size_t)r * W + i];

  int o_base = 0, c_base = 0;  // o and c at the diagonal before the chunk
  int o_prev = 0, c_prev = 0;  // and before the chunk before
  for (int q = 0; q * CHUNK < k_pad; ++q) {
    const int cur = q & 1;
    const int base = q * CHUNK;  // the chunk holds diagonals base + 1 ..
    const int rows = min(CHUNK, k_pad - base);  // a multiple of 32
    // 1. two stream bytes a thread, coalesced
    const int i0 = 2 * t;
    uint32_t pair = 0;
    if (i0 < rows) pair = *reinterpret_cast<const uint16_t*>(st + base + i0);
    const int b0 = pair & 0xFF, b1 = (pair >> 8) & 0xFF;
    const int d0 = (b0 >> 6) & 1, d1 = (b1 >> 6) & 1;
    // 2. block-wide inclusive scan of bit 6 over the chunk
    int v = d0 + d1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) sm.wsum[warp] = v;
    __syncthreads();  // every thread is also done with the last chunk's rows
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int s = sm.wsum[w];
      before += w < warp ? s : 0;
      total += s;
    }
    if (i0 < rows) {
      const int oa = o_base + before + v - d1;  // o at diagonal base + i0 + 1
      const int ob = oa + d1;                   // and at base + i0 + 2
      const int ca = base + i0 + 1 - oa, cb = ca + 1 - d1;
      sm.sb[i0] = (uint8_t)b0;
      sm.sb[i0 + 1] = (uint8_t)b1;
      sm.ok[i0] = oa;
      sm.ok[i0 + 1] = ob;
      // 3. scatter the entering symbols: X[W - 1 + o], Y[c]
      if (d0)
        sm.xb[cur][W - 1 + oa - o_base] = (uint8_t)(b0 & 7);
      else
        sm.yb[cur][c_base + CHUNK - ca] = (uint8_t)(b0 & 7);
      if (d1)
        sm.xb[cur][W - 1 + ob - o_base] = (uint8_t)(b1 & 7);
      else
        sm.yb[cur][c_base + CHUNK - cb] = (uint8_t)(b1 & 7);
    }
    // the buffers' heads, from the last chunk's: X[o_base .. o_base + W - 1]
    // and Y[c_base - W + 1 .. c_base] (the Y entries at t <= 0 are never read)
    if (q > 0) {
      for (int i = t; i < W; i += THREADS) {
        sm.xb[cur][i] = sm.xb[cur ^ 1][o_base - o_prev + i];
        sm.yb[cur][CHUNK + i] = sm.yb[cur ^ 1][c_prev + CHUNK - c_base + i];
      }
    }
    __syncthreads();
    // 4. the rows: 16 cells a thread, one 16-byte store
#pragma unroll 1
    for (int idx = t; idx < rows * (W / CELLS); idx += THREADS) {
      const int row = idx / (W / CELLS);
      const int w0 = (idx % (W / CELLS)) * CELLS;
      const int k = base + row + 1;
      const int o = sm.ok[row];
      const int c = k - o;
      const int top = sm.sb[row] & 0xC0;
      const uint8_t* xs = sm.xb[cur] + (o - o_base + w0);
      const uint8_t* ys = sm.yb[cur] + (c_base + CHUNK - c + w0);
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int cc = 0; cc < CELLS; ++cc) {
        const int j = o + w0 + cc;
        const int i = c - w0 - cc;
        const bool okc = j <= nr && i >= 0 && i <= mr && w0 + cc < wl;
        const int xv = (okc && j >= 1) ? xs[cc] : 5;
        const int yv = (okc && i >= 1) ? ys[cc] : 5;
        wd[cc >> 2] |= (uint32_t)((xv * 8 + yv + top) & 0xFF) << (8 * (cc & 3));
      }
      *reinterpret_cast<uint4*>(out + (size_t)(base + row) * W + w0) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    o_prev = o_base;
    c_prev = c_base;
    o_base += total;
    c_base += rows - total;
  }
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Registers, local memory (spill) bytes per thread, static shared memory
// bytes and threads per block (one block a read) at band width W, into
// out[4].
extern "C" int np_pack_attrs(int W, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (W == 2048)
    e = cudaFuncGetAttributes(&a, pack_kernel<2048>);
  else if (W == 1536)
    e = cudaFuncGetAttributes(&a, pack_kernel<1536>);
  else if (W == 1024)
    e = cudaFuncGetAttributes(&a, pack_kernel<1024>);
  else if (W == 768)
    e = cudaFuncGetAttributes(&a, pack_kernel<768>);
  else if (W == 512)
    e = cudaFuncGetAttributes(&a, pack_kernel<512>);
  else if (W == 384)
    e = cudaFuncGetAttributes(&a, pack_kernel<384>);
  else if (W == 256)
    e = cudaFuncGetAttributes(&a, pack_kernel<256>);
  else if (W == 128)
    e = cudaFuncGetAttributes(&a, pack_kernel<128>);
  else if (W == 64)
    e = cudaFuncGetAttributes(&a, pack_kernel<64>);
  else if (W == 32)
    e = cudaFuncGetAttributes(&a, pack_kernel<32>);
  else
    return (int)cudaErrorInvalidValue;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = THREADS;
  return (int)e;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  W is
// 32, 64, 128, 256, 384, 512, 768, 1024, 1536 or 2048 and `wl` the live
// band width, 1 <= wl <= W.
extern "C" int np_pack_launch(const void* stream_bytes, const void* initx,
                              const void* m, const void* n, int nreads,
                              int k_pad, int W, int wl, void* xyc, void* stream) {
  if (nreads <= 0 || k_pad % 32 != 0 || wl < 1 || wl > W) return (int)cudaErrorInvalidValue;
  const dim3 grid(nreads), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sb = (const uint8_t*)stream_bytes;
  const uint8_t* ix = (const uint8_t*)initx;
  const int32_t* mm = (const int32_t*)m;
  const int32_t* nn = (const int32_t*)n;
  uint8_t* out = (uint8_t*)xyc;
  if (W == 2048) {
    pack_kernel<2048><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 1536) {
    pack_kernel<1536><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 1024) {
    pack_kernel<1024><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 768) {
    pack_kernel<768><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 512) {
    pack_kernel<512><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 384) {
    pack_kernel<384><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 256) {
    pack_kernel<256><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 128) {
    pack_kernel<128><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 64) {
    pack_kernel<64><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else if (W == 32) {
    pack_kernel<32><<<grid, block, 0, s>>>(sb, ix, mm, nn, k_pad, wl, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
