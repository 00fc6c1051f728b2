// The staging shared by the two walkers (csrc/traceback.cu, the MEA
// walker going up; csrc/viterbi_traceback.cu, the Viterbi walker going
// down).  One warp serves one read: its rows (direction codes or
// backpointers, W cells of type T a diagonal: bytes, or the Viterbi full
// plane's 16-bit cells; one contiguous range a read) stream
// into a shared-memory ring of NBUF chunks of chunk<W, T>() diagonals
// (CH, CH / 2 where a row is more than 512 bytes, CH / 4 where it is
// more than 1024), NBUF - 1
// chunks ahead of the walk, by the lanes' cp.async copies: the rows 16
// bytes a copy, the column-0 code word of each of the chunk's diagonals
// (4 bytes a row of the packed band codes, W bytes apart) 4 bytes a
// copy, one commit group a chunk.  A warp scan of bit 6 of those words
// gives the chunk's band offsets o[k].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr int WARPS = 4;  // reads per block, but see reads_per_block
constexpr int CH = 128;   // diagonals per staged chunk, but see chunk
constexpr int NBUF = 3;   // ring depth: chunks in flight ahead of the walk
constexpr int OFF = 4;    // o[] holds diagonal lo + kk at OFF + kk, kk >= -OFF
constexpr unsigned FULL = 0xffffffffu;

// Diagonals a staged chunk of a walker over rows of T at band width W:
// CH, but CH / 2 where a row is more than 512 bytes (the full plane's
// 16-bit rows at W = 384 and 512, the byte rows at W = 768 and 1024),
// whose ring of three chunks of CH (294,912 and 393,216 bytes of rows at
// W = 384 and 512's 16-bit rows, as many at 768 and 1024's bytes) would
// not fit in the 232,448 a block may opt into, and CH / 4 where a row is
// more than 1024 bytes (the full plane's 16-bit rows at W = 768 and
// 1024, the byte rows at W = 1536 and 2048: three chunks of CH / 2 would
// take 294,912 and 393,216 bytes)
template <int W, typename T>
__host__ __device__ constexpr int chunk() {
  return W * (int)sizeof(T) > 1024  ? CH / 4
         : W * (int)sizeof(T) > 512 ? CH / 2
                                    : CH;
}

template <int W, typename T = int8_t>
struct __align__(16) Stage {
  static constexpr int K = chunk<W, T>();
  T rows[NBUF][K * W];       // row i of a slot: diagonal c*K + i
  uint32_t code[NBUF][K];    // column-0 code word of each diagonal
  int32_t o[OFF + K + OFF];  // band offsets of the walked chunk; the
                             // walk's look-ahead reads OFF past each end
  uint8_t ops[K + 16];       // its op row, at the global row's alignment
};

// Reads (warps) a block of a walker over rows of T at band width W:
// WARPS, but 2 where a row is 256 bytes (the full plane's 16-bit rows at
// W = 128, the byte rows at W = 256), whose ring of 4 reads (402,112
// bytes either) would not fit in the 232,448 a block may opt into, and 1
// where a row is more: the full plane at W = 256 and the byte rows at
// W = 512 (198,832 bytes a read), the byte rows at W = 384 (149,680), the
// full plane at W = 384 and 512 and the byte rows at W = 768 and 1024 on
// chunks of CH / 2 (148,592 and 197,744 either), and the full plane at
// W = 768 and 1024 and the byte rows at W = 1536 and 2048 on chunks of
// CH / 4 (148,048 and 197,200 either)
template <int W, typename T>
__host__ __device__ constexpr int reads_per_block() {
  return W * (int)sizeof(T) > 256 ? 1 : W * (int)sizeof(T) > 128 ? 2 : WARPS;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every chunk's group but the newest NBUF - 2 has landed (this lane's
// copies; the caller's __syncwarp shows every lane's to the warp)
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NBUF - 2) : "memory");
}

// Chunk c of one read into ring slot `slot`: its rows c*K .. c*K +
// nrows - 1 of `src` (K = chunk<W, T>()) and the column-0 code word of
// each of its diagonals k >= 1 (code row k - 1 of `xy`).  One commit,
// empty or not, per chunk index.
template <int W, typename T>
__device__ __forceinline__ void stage_chunk(Stage<W, T>& sg, const T* src,
                                            const uint8_t* xy, int c, int nrows, int slot,
                                            int lane) {
  if (nrows > 0) {
    const int lo = c * Stage<W, T>::K;
    const char* from = (const char*)(src + (size_t)lo * W);
    for (int i = lane * 16; i < nrows * W * (int)sizeof(T); i += 32 * 16)
      cp_async16((char*)sg.rows[slot] + i, from + i);
    for (int i = lane; i < nrows; i += 32)
      if (lo + i >= 1) cp_async4(&sg.code[slot][i], xy + (size_t)(lo + i - 1) * W);
  }
  cp_commit();
}

// The chunk's band offsets from bit 6 of its code words: lane l owns
// diagonals lo + PER*l .. + PER - 1, one inclusive warp scan adds them
// up.  Going up, `carry` is o[lo - 1] and the result o[lo + nrows - 1];
// going down (`down`), the reverse.  Writes o[OFF + i] = o[lo + i].
template <int W, typename T>
__device__ __forceinline__ int scan_offsets(Stage<W, T>& sg, int slot, int lo, int nrows,
                                            int carry, bool down, int lane) {
  constexpr int PER = Stage<W, T>::K / 32;
  int v[PER];
  int s = 0;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int i = PER * lane + t;
    s += (i < nrows && lo + i >= 1) ? (int)((sg.code[slot][i] >> 6) & 1u) : 0;
    v[t] = s;
  }
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int nb = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += nb;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  const int base = down ? carry - total : carry;  // o[lo - 1]
#pragma unroll
  for (int t = 0; t < PER; ++t) sg.o[OFF + PER * lane + t] = base + (incl - s) + v[t];
  return down ? base : carry + total;
}

// The op row of the walked chunk, all 3 (none) before the walk
template <int W, typename T>
__device__ __forceinline__ void clear_ops(Stage<W, T>& sg, int lane) {
  for (int t = lane; t < (Stage<W, T>::K + 16) / 4; t += 32)
    reinterpret_cast<uint32_t*>(sg.ops)[t] = 0x03030303u;
}

// bytes [0, nbytes) of global g from shared s, where s and g lie at the
// same address modulo 16: head and tail bytes one by one, the rest in
// 16-byte words
__device__ __forceinline__ void store_row(int8_t* g, const uint8_t* s, int nbytes, int lane) {
  const int head = min(nbytes, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int nw = (nbytes - head) >> 4;
  if (lane < head) g[lane] = (int8_t)s[lane];
  for (int w = lane; w < nw; w += 32)
    *reinterpret_cast<uint4*>(g + head + 16 * w) =
        *reinterpret_cast<const uint4*>(s + head + 16 * w);
  for (int t = head + 16 * nw + lane; t < nbytes; t += 32) g[t] = (int8_t)s[t];
}

// bytes [0, nbytes) of global g set to 3 (none), 16-byte words between
__device__ __forceinline__ void fill_none(int8_t* g, int nbytes, int lane) {
  const int head = min(nbytes, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int nw = (nbytes - head) >> 4;
  const uint4 v = make_uint4(0x03030303u, 0x03030303u, 0x03030303u, 0x03030303u);
  if (lane < head) g[lane] = 3;
  for (int w = lane; w < nw; w += 32) *reinterpret_cast<uint4*>(g + head + 16 * w) = v;
  for (int t = head + 16 * nw + lane; t < nbytes; t += 32) g[t] = 3;
}

// Dynamic shared memory a walker block takes at band width W with rows
// of T: one Stage a read of the block (0 for a W other than 32, 64, 128,
// 256, 384, 512, 768, 1024, 1536 and 2048; the Viterbi walker builds
// none above 1024).  The byte rows take 205,504 bytes at W = 128 (4
// reads), 201,056 at W = 256 (2 reads), 149,680 at W = 384 and 198,832
// at W = 512 (1 read), as the 16-bit rows at W = 128 (2 reads) and
// W = 256 (1 read); the 16-bit rows at W = 384 and 512, on chunks of
// CH / 2, 148,592 and 197,744 (1 read), as the byte rows at W = 768 and
// 1024; the 16-bit rows at W = 768 and 1024, on chunks of CH / 4,
// 148,048 and 197,200 (1 read), as the byte rows at W = 1536 and 2048:
// every walker launches under the 232,448 a block may opt into.
template <int W, typename T>
constexpr int stage_bytes() {
  return reads_per_block<W, T>() * (int)sizeof(Stage<W, T>);
}

template <typename T = int8_t>
inline int smem_bytes(int W) {
  return W == 2048 ? stage_bytes<2048, T>()
       : W == 1536 ? stage_bytes<1536, T>()
       : W == 1024 ? stage_bytes<1024, T>()
       : W == 768 ? stage_bytes<768, T>()
       : W == 512 ? stage_bytes<512, T>()
       : W == 384 ? stage_bytes<384, T>()
       : W == 256 ? stage_bytes<256, T>()
       : W == 128 ? stage_bytes<128, T>()
       : W == 64 ? stage_bytes<64, T>()
       : W == 32 ? stage_bytes<32, T>()
                 : 0;
}

// Launch a walker kernel over rows of T at its dynamic shared memory,
// reads_per_block<W, T>() reads a block; returns cudaGetLastError().
template <int W, typename T = int8_t, typename Kernel, typename... Args>
int launch(Kernel kernel, int nreads, cudaStream_t stream, Args... args) {
  constexpr int R = reads_per_block<W, T>();
  const int smem = stage_bytes<W, T>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(nreads + R - 1) / R, R * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace walk
