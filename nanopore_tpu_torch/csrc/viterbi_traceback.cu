// Viterbi walker: walks a read's backpointer plane down the diagonals
// into per-diagonal ops.
//
// Replaces nanopore_tpu/ops/traceback_pallas.py::_vit_tb_kernel.  From
// cell (m, n) in state fstate the walk visits at most one cell per
// diagonal, descending.  On the diagonal k = i + j of its cell it reads
// the backpointer byte p at band index j - o[k] (0 outside the band),
// emits the op of the move into the cell (M for state 0, D for 1 and 3,
// I for 2 and 4), steps back (i - 1 for M and I, j - 1 for M and D) and
// takes the predecessor state: p % 5 from the match state, for gap
// state s its from-self bit ((p / 5) >> (s - 1)) & 1 times s.  It stops
// at (0, 0) and writes 3 (none) on every diagonal off the path; the cell
// where it stopped goes to `end`, (0, 0) for a whole walk.  The rules
// are ops/traceback.py::viterbi_walk_plain's.  The band offsets o[k] are
// integrated from bit 6 of the packed band codes already on the card:
// summed up to the start diagonal, then subtracted while walking down
// (the TPU walker's descending integration), so no offsets cross the
// bus.
//
// Bound: latency.  The useful traffic is one backpointer byte and one
// code byte per diagonal per read, but each step's load address depends
// on the previous step's move, a serial chain of ~10^4 dependent loads
// per read, after a pass of ~10^4 independent code loads for the start
// offset.  Design: csrc/traceback.cu's, one thread per read and small
// blocks so the reads spread over many SMs and their chains overlap; the
// code byte of each diagonal does not depend on the walk and is loaded
// ahead by the unrolled loops.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
viterbi_walk_kernel(const int8_t* __restrict__ bp, const uint8_t* __restrict__ xyc,
                    const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                    const int32_t* __restrict__ fstate, int nreads, int k_pad,
                    int W, int8_t* __restrict__ ops, int32_t* __restrict__ end) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= nreads) return;
  const int K1 = k_pad + 1;
  const int8_t* pr = bp + (size_t)r * K1 * W;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  int8_t* op = ops + (size_t)r * K1;
  int i = m[r];
  int j = n[r];
  int s = fstate[r];
  const int kstart = i + j < k_pad ? i + j : k_pad;
  int o = 0;  // o[kstart]
#pragma unroll 8
  for (int k = 1; k <= kstart; ++k) o += (xy[(size_t)(k - 1) * W] >> 6) & 1;
  for (int k = k_pad; k > kstart; --k) op[k] = 3;
#pragma unroll 4
  for (int k = kstart; k >= 0; --k) {
    int code = 3;
    if (i + j == k && (i != 0 || j != 0)) {
      const int b = j - o;
      const int p = (b >= 0 && b < W) ? pr[(size_t)k * W + b] : 0;
      const int prev = s == 0 ? p % 5 : s * (((p / 5) >> (s - 1)) & 1);
      const bool is_d = s == 1 || s == 3;
      code = s == 0 ? 0 : (is_d ? 1 : 2);
      i -= !is_d;
      j -= s == 0 || is_d;
      s = prev;
    }
    op[k] = (int8_t)code;
    if (k >= 1) o -= (xy[(size_t)(k - 1) * W] >> 6) & 1;  // o[k-1]
  }
  end[2 * r] = i;
  end[2 * r + 1] = j;
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int np_viterbi_walk_launch(const void* bp, const void* xyc, const void* m,
                                      const void* n, const void* fstate, int nreads,
                                      int k_pad, int W, void* ops, void* end,
                                      void* stream) {
  if (nreads <= 0 || k_pad < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((nreads + THREADS - 1) / THREADS), block(THREADS);
  viterbi_walk_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int8_t*)bp, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n,
      (const int32_t*)fstate, nreads, k_pad, W, (int8_t*)ops, (int32_t*)end);
  return (int)cudaGetLastError();
}
