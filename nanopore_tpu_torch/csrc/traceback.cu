// MEA walker: walks a read's forward direction codes into per-diagonal ops.
//
// Replaces nanopore_tpu/ops/traceback_pallas.py::_mea_tb_kernel.  From
// cell (0, 0) the walk visits at most one cell per diagonal; at the cell
// it reads the direction code at band index j - o[k] and moves M (diag),
// D (del) or I (ins), falling back to D while reference remains, else I,
// where the code is 3 or points off the lattice (the rules of
// ops/traceback.py::mea_walk_plain).  It emits one op per diagonal
// (3 where the path skips the diagonal or has ended).  The band offsets
// o[k] are integrated from bit 6 of the packed band codes already on the
// card, so no offsets cross the bus.
//
// Bound: latency.  The useful traffic is one direction byte, one code
// byte and one op byte per diagonal per read (the bytes bound is
// microseconds), but the walk is a serial chain: each step's cell
// depends on the previous step's move, ~5-6 x 10^3 steps for a read of
// 10^4 diagonals.  A load of device memory on that chain costs its full
// latency at every step.  Design:
//  * one warp per read, WARPS reads a block, so a batch of 512 reads
//    spreads over 128 blocks and every SM (2 reads a block at W = 256,
//    whose ring of 4 reads would not fit a block, and 1 at W = 384 to
//    2048: walk::reads_per_block; above 512 the ring's chunks are 64
//    diagonals, above 1024 32, walk::chunk);
//  * the warp streams the read's direction rows (one contiguous range
//    of (m + n + 1) x W bytes) into a shared-memory ring of chunks of
//    CH diagonals, NBUF - 1 chunks ahead of the walk, by 16-byte cp.async
//    copies, with the column-0 code word of each diagonal by 4-byte
//    copies (csrc/walk.cuh);
//  * the band offsets leave the chain: for each chunk the lanes take
//    bit 6 of its code words and one inclusive warp scan
//    (__shfl_up_sync) turns them into o[k], kept beside the chunk;
//  * one lane walks in shared memory only, jumping straight to its next
//    diagonal (k + 1 or k + 2).  The walk is software-pipelined: before
//    a step's move is known it loads the codes of the three cells the
//    move can reach and the offsets of the step after, so the chain
//    holds one shared-memory load and a few selects a step.  It writes
//    each op into a shared op row for the chunk (prefilled with 3), and
//    the warp stores the row with 16-byte stores (the row is placed at
//    the global row's alignment, so the aligned words map to aligned
//    words);
//  * each read stops at its own end: it walks diagonals 0..m + n and
//    fills the rows past them with 3 by 16-byte stores.
// Serves W = 32, 64, 128, 256, 384, 512, 768, 1024, 1536 and 2048, the
// band widths of the realign kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using namespace walk;

template <int W>
__global__ void __launch_bounds__(reads_per_block<W, int8_t>() * 32)
walk_kernel(const int8_t* __restrict__ dirs, const uint8_t* __restrict__ xyc,
            const int32_t* __restrict__ m, const int32_t* __restrict__ n,
            int nreads, int k_pad, int8_t* __restrict__ ops) {
  constexpr int CH = chunk<W, int8_t>();  // diagonals a staged chunk
  extern __shared__ __align__(16) unsigned char stage_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * reads_per_block<W, int8_t>() + warp;
  if (r >= nreads) return;
  Stage<W>& sg = reinterpret_cast<Stage<W>*>(stage_raw)[warp];
  const int K1 = k_pad + 1;
  const int8_t* dr = dirs + (size_t)r * K1 * W;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  int8_t* op = ops + (size_t)r * K1;
  const int mr = m[r];
  const int nr = n[r];
  const int kw = min(mr + nr, k_pad);  // the last diagonal the walk can reach
  const int nq = kw / CH + 1;
  auto rows_of = [&](int c) { return c < nq ? min(CH, kw + 1 - c * CH) : 0; };

  // rows past the read's end: none
  fill_none(op + kw + 1, k_pad - kw, lane);
#pragma unroll
  for (int c = 0; c < NBUF - 1; ++c) stage_chunk<W>(sg, dr, xy, c, rows_of(c), c, lane);

  int i = 0, j = 0, k = 0;  // the walk's cell; lane 0's
  int obase = 0;            // o[c*CH - 1]
#pragma unroll 1
  for (int c = 0; c < nq; ++c) {
    const int slot = c % NBUF;
    cp_wait_ring();  // chunk c has landed
    __syncwarp();    // and every lane is done with chunk c - 1
    stage_chunk<W>(sg, dr, xy, c + NBUF - 1, rows_of(c + NBUF - 1), (c + NBUF - 1) % NBUF,
                   lane);
    const int lo = c * CH;
    const int nrows = rows_of(c);
    obase = scan_offsets<W>(sg, slot, lo, nrows, obase, false, lane);
    const int phase = (int)((uintptr_t)(op + lo) & 15);
    clear_ops<W>(sg, lane);
    __syncwarp();
    if (lane == 0 && k < lo + nrows && (i < mr || j < nr)) {
      // the walk, software-pipelined: the codes of the three cells the
      // next move can reach (D and I on kk + 1, M on kk + 2) and the
      // offsets the step after needs are loaded before this step's move
      // is known, so one shared-memory load sits on the chain a step
      const int8_t* rows = sg.rows[slot];
      const int32_t* so = sg.o + OFF;  // so[kk]: diagonal lo + kk
      int kk = k - lo;
      const int b0 = j - so[kk];
      int d = (unsigned)b0 < (unsigned)W ? rows[kk * W + b0] : 3;
      int o1 = so[kk + 1], o2 = so[kk + 2];
      while (true) {
        const int o3 = so[kk + 3], o4 = so[kk + 4];
        const int bD = j + 1 - o1, bI = j - o1, bM = j + 1 - o2;
        const bool r1 = kk + 1 < nrows, r2 = kk + 2 < nrows;
        const int dD = r1 && (unsigned)bD < (unsigned)W ? rows[(kk + 1) * W + bD] : 3;
        const int dI = r1 && (unsigned)bI < (unsigned)W ? rows[(kk + 1) * W + bI] : 3;
        const int dM = r2 && (unsigned)bM < (unsigned)W ? rows[(kk + 2) * W + bM] : 3;
        const bool can_diag = d == 0 && i < mr && j < nr;
        const bool can_del = d == 1 && j < nr;
        const bool can_ins = d == 2 && i < mr;
        const bool fb_del = !(can_diag || can_del || can_ins) && j < nr;
        const int code = can_diag ? 0 : ((can_del || fb_del) ? 1 : 2);
        sg.ops[phase + kk] = (uint8_t)code;
        i += code != 1;
        j += code != 2;
        kk += code == 0 ? 2 : 1;
        d = code == 0 ? dM : (code == 1 ? dD : dI);
        o1 = code == 0 ? o3 : o2;
        o2 = code == 0 ? o4 : o3;
        if (kk >= nrows || (i >= mr && j >= nr)) break;
      }
      k = lo + kk;
    }
    __syncwarp();
    store_row(op + lo, sg.ops + phase, nrows, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Dynamic shared memory a block takes at band width W (0 for another W).
extern "C" int np_walk_smem(int W) { return walk::smem_bytes(W); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  dirs
// (nreads, k_pad + 1, W) int8, xyc (nreads, k_pad, W) int8, m and n
// (nreads,) int32, ops (nreads, k_pad + 1) int8 out; W is 32, 64, 128,
// 256, 384, 512, 768, 1024, 1536 or 2048, and dirs is 16-byte aligned.
extern "C" int np_walk_launch(const void* dirs, const void* xyc, const void* m,
                              const void* n, int nreads, int k_pad, int W,
                              void* ops, void* stream) {
  if (nreads <= 0 || k_pad < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 2048)
    return launch<2048>(walk_kernel<2048>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                        (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 1536)
    return launch<1536>(walk_kernel<1536>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                        (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 1024)
    return launch<1024>(walk_kernel<1024>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                        (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 768)
    return launch<768>(walk_kernel<768>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                       (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 512)
    return launch<512>(walk_kernel<512>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                       (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 384)
    return launch<384>(walk_kernel<384>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                       (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 256)
    return launch<256>(walk_kernel<256>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                       (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 128)
    return launch<128>(walk_kernel<128>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                       (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 64)
    return launch<64>(walk_kernel<64>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                      (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  if (W == 32)
    return launch<32>(walk_kernel<32>, nreads, s, (const int8_t*)dirs, (const uint8_t*)xyc,
                      (const int32_t*)m, (const int32_t*)n, nreads, k_pad, (int8_t*)ops);
  return (int)cudaErrorInvalidValue;
}
