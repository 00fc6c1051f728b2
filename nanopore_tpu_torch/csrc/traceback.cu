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
// byte and one op byte per diagonal per read, but each step's load
// address depends on the previous step's move, a serial chain of ~10^4
// dependent loads per read.  Design: one thread per read, small blocks
// so the reads spread over many SMs and their chains overlap; the code
// byte of each diagonal does not depend on the walk and is loaded ahead
// by the unrolled loop.  A warp-cooperative walk that prefetches whole
// direction rows is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
walk_kernel(const int8_t* __restrict__ dirs, const uint8_t* __restrict__ xyc,
            const int32_t* __restrict__ m, const int32_t* __restrict__ n,
            int nreads, int k_pad, int W, int8_t* __restrict__ ops) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= nreads) return;
  const int K1 = k_pad + 1;
  const int8_t* dr = dirs + (size_t)r * K1 * W;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;
  int8_t* op = ops + (size_t)r * K1;
  const int mr = m[r];
  const int nr = n[r];
  int i = 0, j = 0, nk = 0, o = 0;
#pragma unroll 4
  for (int k = 0; k < K1; ++k) {
    if (k >= 1) o += (xy[(size_t)(k - 1) * W] >> 6) & 1;
    int code = 3;
    if (nk == k && (i < mr || j < nr)) {
      const int b = j - o;
      const int d = (b >= 0 && b < W) ? dr[(size_t)k * W + b] : 3;
      const bool can_diag = d == 0 && i < mr && j < nr;
      const bool can_del = d == 1 && j < nr;
      const bool can_ins = d == 2 && i < mr;
      const bool fb_del = !(can_diag || can_del || can_ins) && j < nr;
      code = can_diag ? 0 : ((can_del || fb_del) ? 1 : 2);
      i += code != 1;
      j += code != 2;
      nk = i + j;
    }
    op[k] = (int8_t)code;
  }
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int np_walk_launch(const void* dirs, const void* xyc, const void* m,
                              const void* n, int nreads, int k_pad, int W,
                              void* ops, void* stream) {
  if (nreads <= 0 || k_pad < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((nreads + THREADS - 1) / THREADS), block(THREADS);
  walk_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int8_t*)dirs, (const uint8_t*)xyc, (const int32_t*)m,
      (const int32_t*)n, nreads, k_pad, W, (int8_t*)ops);
  return (int)cudaGetLastError();
}
