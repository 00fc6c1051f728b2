// Viterbi walker: walks a read's backpointer plane down the diagonals
// into per-diagonal ops.
//
// Replaces nanopore_tpu/ops/traceback_pallas.py::_vit_tb_kernel (the
// byte plane) and, for the full plane of a model outside the canonical
// fiveState structure, nanopore_tpu/ops/viterbi.py::viterbi_traceback.
// From cell (m, n) in state fstate the walk visits at most one cell per
// diagonal, descending.  On the diagonal k = i + j of its cell it reads
// the backpointer p at band index j - o[k] (0 outside the band), emits
// the op of the move into the cell (M for state 0, D for 1 and 3, I for
// 2 and 4), steps back (i - 1 for M and I, j - 1 for M and D) and takes
// the predecessor state.  The two planes of csrc/viterbi.cu, one kernel
// instantiation each:
//  * the byte plane (int8 rows, p = bM + 5 * (tD1 + 2 tI1 + 4 tD2 +
//    8 tI2), a canonical model): p % 5 from the match state, for gap
//    state s its from-self bit ((p / 5) >> (s - 1)) & 1 times s;
//  * the full plane (int16 rows, p = sum_s b_s << 3s, any other model):
//    (p >> 3s) & 7 from state s.
// It stops
// at (0, 0), or below diagonal 0, and writes 3 (none) on every diagonal
// off the path; the cell where it stopped goes to `end`, (0, 0) for a
// whole walk.  A read with m + n > k_pad is not walked (its ops are all
// 3, its end (m, n)).  The rules are ops/traceback.py::viterbi_walk_plain's.
// The band offsets o[k] are integrated from bit 6 of the packed band
// codes already on the card, so no offsets cross the bus.
//
// Bound: latency.  The useful traffic is one backpointer cell (1 or 2
// bytes) and one code byte per path diagonal per read, and one op byte
// per diagonal (the bytes bound is microseconds), but the walk is a
// serial chain:
// each step's cell depends on the previous step's move.  Design: that
// of csrc/traceback.cu, going down:
//  * one warp per read, WARPS = 4 reads a block, but 2 for the full
//    plane at W = 128 and the byte plane at W = 256, and 1 for the full
//    plane at W = 256 and for both planes at W = 384 to 1024
//    (walk::reads_per_block);
//  * o[kstart] (kstart = min(m + n, k_pad)) first, as one warp-parallel
//    sum of d1[1..kstart]: independent strided loads, then
//    __reduce_add_sync; meanwhile the first chunks are in flight;
//  * the warp streams the read's backpointer rows from kstart down into
//    a shared-memory ring of chunks of CH diagonals (chunk c holds rows
//    c*CH ..; CH = walk::chunk<W, T>(): 128, but 64 for rows of more
//    than 512 bytes and 32 for the full plane's rows of more than 1024),
//    NBUF - 1 chunks ahead of the walk, by
//    16-byte cp.async copies, with the column-0 code word of each
//    diagonal by 4-byte copies (csrc/walk.cuh); one warp scan per chunk
//    turns bit 6 of those words into the chunk's o[k], carried down from
//    o[kstart].
//    The full plane's ring is twice the bytes: 205,504 B a block of 4
//    reads at W = 64, within the 227 KB a block may take (one block an
//    SM either way at B = 512: 128 blocks on 132 SMs); at W = 128 a read's
//    int16 ring is 100,528 B, so a block holds 2 reads (201,056 B), one
//    block an SM, 256 blocks at B = 512 (the byte ring, 205,504 B a
//    block of 4, as K3's); at W = 256 the byte ring is 100,528 B too (2
//    reads a block, as K3's at 256) and the int16 ring 198,832 B, one
//    read a block and an SM, 512 blocks at B = 512; at W = 384 and 512
//    the byte ring is K3's (149,680 and 198,832 B, one read a block), and
//    the int16 ring, whose three chunks of 128 rows of 768 or 1,024 B
//    would take 294,912 or 393,216 B, stages chunks of 64 diagonals:
//    148,592 and 197,744 B, one read a block; at W = 768 and 1024 the
//    byte ring is K3's again (chunks of 64: 148,592 and 197,744 B), and
//    the int16 rows of 1,536 and 2,048 B take chunks of 32 diagonals
//    (three of 64 would take 294,912 and 393,216 B): 148,048 and
//    197,200 B, one read a block;
//  * one lane walks in shared memory only, jumping straight to its next
//    diagonal (k - 1 or k - 2).  The walk is software-pipelined: the
//    state decides the next cell before the current backpointer is
//    decoded, so the next cell's byte is loaded (its offset from the two
//    loaded a step ahead) while the current one is decoded.  It writes
//    each op into a shared op row (prefilled with 3) that the warp
//    stores with 16-byte stores;
//  * the rows above kstart are filled with 3 by 16-byte stores.
// Serves W = 32, 64, 128, 256, 384, 512, 768 and 1024, the Viterbi
// kernel's widths.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using namespace walk;

template <int W, typename T>
__global__ void __launch_bounds__(reads_per_block<W, T>() * 32)
viterbi_walk_kernel(const T* __restrict__ bp, const uint8_t* __restrict__ xyc,
                    const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                    const int32_t* __restrict__ fstate, int nreads, int k_pad,
                    int8_t* __restrict__ ops, int32_t* __restrict__ end) {
  constexpr int CH = chunk<W, T>();  // diagonals a staged chunk
  extern __shared__ __align__(16) unsigned char stage_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * reads_per_block<W, T>() + warp;
  if (r >= nreads) return;
  Stage<W, T>& sg = reinterpret_cast<Stage<W, T>*>(stage_raw)[warp];
  const int K1 = k_pad + 1;
  const T* pr = bp + (size_t)r * K1 * W;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  int8_t* op = ops + (size_t)r * K1;
  int i = m[r];
  int j = n[r];
  int s = fstate[r];
  const bool walks = i + j <= k_pad;  // else no diagonal holds its cell
  const int kstart = walks ? i + j : k_pad;
  const int ctop = kstart / CH;  // chunks ctop, ctop - 1, .., 0
  auto rows_of = [&](int c) { return c >= 0 ? min(CH, kstart + 1 - c * CH) : 0; };

  fill_none(op + kstart + 1, k_pad - kstart, lane);
#pragma unroll
  for (int q = 0; q < NBUF - 1; ++q)
    stage_chunk<W>(sg, pr, xy, ctop - q, rows_of(ctop - q), q, lane);
  // o[kstart]: d1[1..kstart], independent loads spread over the lanes
  int part = 0;
#pragma unroll 8
  for (int k = 1 + lane; k <= kstart; k += 32) part += (xy[(size_t)(k - 1) * W] >> 6) & 1;
  int otop = __reduce_add_sync(FULL, part);  // o[top of the current chunk]

  int k = kstart;  // the walk's diagonal; lane 0's
#pragma unroll 1
  for (int q = 0; q <= ctop; ++q) {
    const int c = ctop - q;
    const int slot = q % NBUF;
    cp_wait_ring();  // chunk c has landed
    __syncwarp();    // and every lane is done with the chunk before
    stage_chunk<W>(sg, pr, xy, c - (NBUF - 1), rows_of(c - (NBUF - 1)), (q + NBUF - 1) % NBUF,
                   lane);
    const int lo = c * CH;
    const int nrows = rows_of(c);
    otop = scan_offsets<W>(sg, slot, lo, nrows, otop, true, lane);
    const int phase = (int)((uintptr_t)(op + lo) & 15);
    clear_ops<W>(sg, lane);
    __syncwarp();
    if (lane == 0 && walks && k >= lo && (i != 0 || j != 0)) {
      // the walk, software-pipelined: the state decides the next cell
      // before the backpointer of this one is decoded, so the load of
      // the next cell's byte (its offset taken from the two loaded a
      // step ahead) is issued first and overlaps the decode
      const T* rows = sg.rows[slot];
      const int32_t* so = sg.o + OFF;  // so[kk]: diagonal lo + kk, kk >= -OFF
      int kk = k - lo;
      const int b0 = j - so[kk];
      int p = (unsigned)b0 < (unsigned)W ? rows[kk * W + b0] : 0;
      int om1 = so[kk - 1], om2 = so[kk - 2];
      while (true) {
        const int o3 = so[kk - 3], o4 = so[kk - 4];
        const bool is_m = s == 0;
        const bool is_d = s == 1 || s == 3;
        sg.ops[phase + kk] = (uint8_t)(is_m ? 0 : (is_d ? 1 : 2));
        i -= !is_d;
        j -= is_m || is_d;
        const int kn = kk - (is_m ? 2 : 1);
        const int bn = j - (is_m ? om2 : om1);
        const int pn = kn >= 0 && (unsigned)bn < (unsigned)W ? rows[kn * W + bn] : 0;
        if constexpr (sizeof(T) == 2)
          s = (p >> (3 * s)) & 7;
        else
          s = is_m ? p % 5 : s * (((p / 5) >> (s - 1)) & 1);
        om1 = is_m ? o3 : om2;
        om2 = is_m ? o4 : o3;
        kk = kn;
        p = pn;
        if (kk < 0 || (i == 0 && j == 0)) break;
      }
      k = lo + kk;
    }
    __syncwarp();
    store_row(op + lo, sg.ops + phase, nrows, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (lane == 0) {
    end[2 * r] = i;
    end[2 * r + 1] = j;
  }
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

namespace {

template <int W, typename T>
int attrs_width(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, viterbi_walk_kernel<W, T>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = walk::stage_bytes<W, T>();
  out[4] = walk::reads_per_block<W, T>() * 32;
  out[5] = walk::reads_per_block<W, T>();
  return (int)e;
}

template <typename T>
int attrs_plane(int W, int* out) {
  if (W == 1024) return attrs_width<1024, T>(out);
  if (W == 768) return attrs_width<768, T>(out);
  if (W == 512) return attrs_width<512, T>(out);
  if (W == 384) return attrs_width<384, T>(out);
  if (W == 256) return attrs_width<256, T>(out);
  if (W == 128) return attrs_width<128, T>(out);
  if (W == 64) return attrs_width<64, T>(out);
  if (W == 32) return attrs_width<32, T>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Registers, local memory (spill) bytes per thread, static and dynamic
// shared memory bytes per block, threads per block and reads per block
// of the walk at band width W over the full plane's 16-bit rows if
// `full`, else the byte plane's, into out[6].
extern "C" int np_viterbi_walk_attrs(int W, int full, int* out) {
  return full ? attrs_plane<int16_t>(W, out) : attrs_plane<int8_t>(W, out);
}

namespace {

template <int W, typename T>
int launch_at(const void* bp, const void* xyc, const void* m, const void* n,
              const void* fstate, int nreads, int k_pad, void* ops, void* end,
              cudaStream_t s) {
  return walk::launch<W, T>(viterbi_walk_kernel<W, T>, nreads, s, (const T*)bp,
                            (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n,
                            (const int32_t*)fstate, nreads, k_pad, (int8_t*)ops,
                            (int32_t*)end);
}

template <typename T>
int launch_plane(const void* bp, const void* xyc, const void* m, const void* n,
                 const void* fstate, int nreads, int k_pad, int W, void* ops, void* end,
                 cudaStream_t s) {
  auto fn = W == 1024  ? launch_at<1024, T>
            : W == 768 ? launch_at<768, T>
            : W == 512 ? launch_at<512, T>
            : W == 384 ? launch_at<384, T>
            : W == 256 ? launch_at<256, T>
            : W == 128 ? launch_at<128, T>
            : W == 64  ? launch_at<64, T>
            : W == 32  ? launch_at<32, T>
                       : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(bp, xyc, m, n, fstate, nreads, k_pad, ops, end, s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  bp
// (nreads, k_pad + 1, W): the byte plane, int8, or (`full`) the full
// plane, int16; xyc (nreads, k_pad, W) int8, m, n and fstate (nreads,)
// int32, ops (nreads, k_pad + 1) int8 and end (nreads, 2) int32 out; W is
// 32, 64, 128, 256, 384, 512, 768 or 1024, and bp is 16-byte aligned.
extern "C" int np_viterbi_walk_launch(const void* bp, const void* xyc, const void* m,
                                      const void* n, const void* fstate, int nreads,
                                      int k_pad, int W, int full, void* ops, void* end,
                                      void* stream) {
  if (nreads <= 0 || k_pad < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return full ? launch_plane<int16_t>(bp, xyc, m, n, fstate, nreads, k_pad, W, ops, end, s)
              : launch_plane<int8_t>(bp, xyc, m, n, fstate, nreads, k_pad, W, ops, end, s);
}
