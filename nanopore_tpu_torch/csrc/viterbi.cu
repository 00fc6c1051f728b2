// Banded five-state Viterbi: the max-product forward over packed band
// codes, one backpointer cell per band cell per diagonal.
//
// Replaces nanopore_tpu/ops/pairhmm_pallas_viterbi.py::_viterbi_kernel
// (the byte plane) and, for a model outside the canonical fiveState
// structure, nanopore_tpu/ops/viterbi.py::_viterbi_scan_single (the full
// plane).  Log space, no rescaling.  Per diagonal k and destination
// state, the max and argmax over the predecessor states (pred +
// ltf[s*5 + dest], a tie keeps the lower state) are taken before the band
// shift (match from diagonal k-2 by d2, deletes from k-1 by d1 - 1,
// inserts from k-1 by d1; NEG and backpointer 0 shifted in), then the
// emission is added and the sum clamped at NEG.  A cell whose x or y code
// is the sentinel 5 emits NEG; N = 4 is a real code.  At band cell 0 of
// diagonal k_end = m + n the score and its argmax state (strict >) are
// captured.  The arithmetic is the plain version's in ops/viterbi.py, in
// its order: adds and maxima only, so the two agree to the bit.
//
// Two planes; the wrapper picks one by the model's structure:
//  * the byte plane (int8), for a model in the canonical fiveState
//    structure, where a gap state is entered only from match or itself:
//    p = bM + 5 * (tD1 + 2 tI1 + 4 tD2 + 8 tI2), the gap states collapsed
//    to from-self bits.  Its tables put structure zeros at NEG.  Two
//    steps serve it, STEP_SHORT and STEP_FIVE_WAY below;
//  * the full plane (int16, STEP_FULL), for every other model:
//    p = bM + (bD1 << 3) + (bI1 << 6) + (bD2 << 9) + (bI2 << 12), each
//    state's predecessor state.  Its tables take log(max(t, 1e-37)) of
//    every transition, as the JAX package's XLA scan does (a structure
//    zero is about -85.2 and may decide a cell).  Its step is the 5-way
//    step keeping each gap destination's argmax state.
//
// The short step (STEP_SHORT): a gap destination g takes the max of its two
// allowed candidates, from match and from itself, and its bit is (from
// self > from match).  The 5-way step's bit is 1 exactly when its max
// exceeds the match candidate, which comes first (strict >).  Every state
// value is NEG or a real log score no more than 0 (|v| < 1e8: a diagonal
// adds at least 2 log(1e-37)), so a disallowed candidate, v + NEG, rounds
// to NEG or -2e30, and one through a positive transition, v + log(t)
// with log(t) >= log(1e-37), is at least NEG (NEG - 85 rounds to NEG).
// So where t[match -> g] > 0 or t[g -> g] > 0, one allowed candidate is
// at least every disallowed one, the 5-way max is the max of the two
// allowed candidates, and the value and the bit are the short step's.
// Only a gap state that neither enters (both entries 0) can differ: where
// its match and own predecessors are NEG beside a real disallowed one,
// in the bit, at a value that clamps to NEG.  The wrapper takes the
// 5-way step (the same kernel's other template path) for such a model
// and the short step otherwise, as for every shipped model.  The match
// destination keeps its 5 predecessors either way.
//
// Bound: operations, just above the bytes (one code byte in and one
// backpointer byte out a cell; two for the full plane).  Per band cell
// per diagonal the 5-way and full steps do 95 operations (25 adds, 20
// compares, 20 maxima and 20 argmax selects; then 5 adds and 5 maxima for
// the emissions, whose validity select is a function of the code alone,
// a lookup), the short step 43 (17 for the match state, 2 adds, a max and
// a compare for each gap state, 10 for the emissions).  In fact each read
// is a serial chain of ~10^4 diagonals, so a diagonal's latency and, at
// B = 512 (one warp a scheduler), its issue slots set the time.  Design:
//  * one warp per read, two reads a block; a lane owns C = W/32 adjacent
//    band cells in registers (W = 32, 64 or 128), so a band shift is one
//    warp shuffle;
//  * above W = 128 a read's band is held by a group of G = W / 128
//    warps of C = 4 cells a lane (W = 128's registers a thread), warp wg
//    owning cells 128 wg .. 128 wg + 127 (csrc/group.cuh), one read a
//    block of 32 G threads: G = 2 at W = 256 (17 KB of static shared
//    memory, so all 512 reads of the mapping batch are resident at
//    once), G = 3 at W = 384 and G = 4 at W = 512 (a stage of 25,344 and
//    33,792 B, still static; at ~168 registers a thread three blocks of
//    128 threads fit an SM, so 396 of 512 reads are resident at W = 512
//    and the rest run in a second wave), G = 6 at W = 768 and G = 8 at
//    W = 1024 (a stage of 50,688 and 67,584 B, past the 48 KB of static
//    shared memory: there it is dynamic, opted into at launch; at ~168
//    registers two blocks of 192 threads fit an SM at W = 768 and one of
//    256 at W = 1024, so 132 of 512 reads are resident at once and the
//    mapping batch runs in four waves).  A diagonal's band shifts move
//    one cell of eight arrays across each seam between two warps (the
//    match state and its argmax by d2, states 2 and 4 and their field
//    upward, states 1 and 3 and theirs downward): each warp's lane 0
//    publishes its first cells and lane 31 its last, in one exchange
//    through shared memory (a middle warp reads both neighbours' edges),
//    one named barrier (bar.sync id, 32 G) a diagonal.  The shift is the
//    kernel's only exchange (no rescale, no band maximum).  The group
//    stages its chunks together and syncs on the same barrier; warp 0's
//    lane 0 holds band cell 0 and so the end cell, the score and fstate.
//    The cells and their arithmetic are W = 128's, so the bits are the
//    plain version's;
//  * the codes are staged through shared memory in chunks of CH + 1 rows
//    with cp.async, double-buffered (the next chunk is in flight while
//    this one is computed), and the emissions and band deltas of the
//    diagonal after the one computed are looked up during its step: no
//    global load sits on the chain.  The emission tables are rebuilt in
//    shared memory with the sentinel folded in (x or y code 5-7 gives
//    NEG), one lookup a state and cell;
//  * the transitions are compile-time-indexed kernel arguments, read as
//    operands, not loaded;
//  * the band shifts take no branch (with one warp a scheduler a branch's
//    bubble is not hidden): states 1 and 3 shift by d1 - 1 and states 2
//    and 4 by d1, so each pair moves one way or not at all: its two floats
//    and its two plane fields (pre-weighted as 5 tD1 + 20 tD2 and
//    10 tI1 + 40 tI2, or bD1 << 3 | bD2 << 9 and bI1 << 6 | bI2 << 12, one
//    int) are shuffled and then selected by d1; the match state and its
//    argmax are shuffled both ways and selected by d2;
//  * the group writes one backpointer row per diagonal, coalesced (W
//    bytes, 2W for the full plane: a lane stores its C cells as one word,
//    8 bytes for the full plane at C = 4);
//    a read stops at its own end diagonal and zeroes the rows above it
//    with 16-byte stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "group.cuh"
#include "walk.cuh"

namespace {

constexpr int NS = 5;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CH = 32;    // diagonals per staged chunk
constexpr int NTAB = 91;  // ltf 25 | lemf 36 | legf 30
constexpr int XW = 5;     // words a warp edge gives the seam each diagonal
// the steps (ops/viterbi.py: FIVE_WAY, SHORT, FULL)
constexpr int STEP_FIVE_WAY = 0, STEP_SHORT = 1, STEP_FULL = 2;

// a lane's C plane cells, stored as one word (8 bytes: the full plane
// at C = 4)
template <int C, typename Cell>
using Word = std::conditional_t<
    C * sizeof(Cell) == 8, uint64_t,
    std::conditional_t<C * sizeof(Cell) == 4, uint32_t,
                       std::conditional_t<C * sizeof(Cell) == 2, uint16_t, uint8_t>>>;

struct Tables {
  float v[NTAB];
};

// The emissions with the sentinel folded in: em[x * 8 + y] for the match
// state and gap[s - 1][x or y] for gap state s, NEG where a code is 5 or
// above (the plain version's validity select, as a lookup)
struct Emit {
  float em[64];
  float gap[4][8];
};

// One read's two code chunks of W-byte rows: row i of chunk q holds
// diagonal q*CH + i + 1 (CH + 1 rows, so the look-ahead of the chunk's
// last step stays in it)
template <int W>
struct __align__(16) Stage {
  uint8_t cd[2][CH + 1][W];
};

// Dynamic shared memory a block takes: one read's stage where the group
// has more than four warps (past the 48 KB of static shared memory),
// else none
template <int C, int G>
__host__ __device__ constexpr int dynamic_smem() {
  return G > 4 ? (int)sizeof(Stage<32 * C * G>) : 0;
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// out[w] = a[w + s] for a group-uniform s in {-1, 0, 1}: both neighbours
// shuffled, then selected (no branch); at the warp's top `hi` comes in,
// at its bottom `lo` (the fill at the band's edges, the other warp's cell
// at a seam)
template <int C, typename T>
__device__ __forceinline__ void shift_sel(T (&a)[C], int s, T hi, T lo, int lane) {
  const T up = __shfl_down_sync(FULL, a[0], 1);
  const T dn = __shfl_up_sync(FULL, a[C - 1], 1);
  T o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T plus = c < C - 1 ? a[c + 1] : (lane == 31 ? hi : up);
    const T minus = c > 0 ? a[c - 1] : (lane == 0 ? lo : dn);
    o[c] = s > 0 ? plus : (s < 0 ? minus : a[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = o[c];
}

// out[w] = move ? a[w + SH] : a[w] (no branch); `edge` comes in at the
// warp's top (SH = 1) or bottom (SH = -1), as for shift_sel
template <int C, int SH, typename T>
__device__ __forceinline__ void shift_if(T (&a)[C], bool move, T edge, int lane) {
  T o[C];
  if constexpr (SH > 0) {
    const T nb = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[c] = c < C - 1 ? a[c + 1] : (lane == 31 ? edge : nb);
  } else {
    const T nb = __shfl_up_sync(FULL, a[C - 1], 1);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = c > 0 ? a[c - 1] : (lane == 0 ? edge : nb);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = move ? o[c] : a[c];
}

// the emissions and top byte of the diagonal whose codes are `row`; a
// lane's C code bytes are one aligned load (w0 = group lane * C, a row is
// a multiple of 16 bytes)
template <int C>
__device__ __forceinline__ void lookup(const Emit& e, const uint8_t* row, int w0,
                                       float (&em)[NS][C], int& top) {
  uint8_t code[C];
  if constexpr (C == 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(row + w0);
#pragma unroll
    for (int c = 0; c < 4; ++c) code[c] = (uint8_t)(v >> (8 * c));
  } else if constexpr (C == 2) {
    const uint16_t v = *reinterpret_cast<const uint16_t*>(row + w0);
    code[0] = (uint8_t)(v & 0xFF);
    code[C - 1] = (uint8_t)(v >> 8);
  } else {
    code[0] = row[w0];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = (code[c] >> 3) & 7;
    const int y = code[c] & 7;
    em[0][c] = e.em[x * 8 + y];
    em[1][c] = e.gap[0][x];
    em[2][c] = e.gap[1][y];
    em[3][c] = e.gap[2][x];
    em[4][c] = e.gap[3][y];
  }
  top = row[0];
}

template <int C, int STEP, int G>
__global__ void __launch_bounds__(grp::reads_per_block(G) * G * 32)
viterbi_kernel(Tables tab, const uint8_t* __restrict__ xyc,
               const int32_t* __restrict__ m, const int32_t* __restrict__ n,
               int nreads, int k_pad, float* __restrict__ score,
               int32_t* __restrict__ fstate, void* __restrict__ bp) {
  constexpr int R = grp::reads_per_block(G);
  constexpr int W = 32 * C * G;
  using Cell = std::conditional_t<STEP == STEP_FULL, uint16_t, uint8_t>;
  using Out = Word<C, Cell>;
  using Acc = std::conditional_t<sizeof(Out) == 8, uint64_t, uint32_t>;
  __shared__ Emit emit;
  Stage<W>* stage;  // the block's reads' stages
  if constexpr (dynamic_smem<C, G>() > 0) {
    extern __shared__ __align__(16) unsigned char stage_raw[];
    stage = reinterpret_cast<Stage<W>*>(stage_raw);
  } else {
    __shared__ Stage<W> stage_static[R];
    stage = stage_static;
  }
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    const int x = i >> 3, y = i & 7;
    emit.em[i] = (x < 5 && y < 5) ? tab.v[25 + x * 6 + y] : NEG;
  }
  for (int i = threadIdx.x; i < 32; i += blockDim.x) {
    const int s = (i >> 3) + 1, v = i & 7;
    emit.gap[s - 1][v] = v < 5 ? tab.v[61 + s * 6 + v] : NEG;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rb = warp / G;  // the read's index in the block
  const int r = blockIdx.x * R + rb;
  if (r >= nreads) return;  // the read's whole group
  uint32_t* xb = nullptr;  // the seam's exchange buffer (G > 1)
  if constexpr (G > 1) {
    __shared__ uint32_t xbuf[R][grp::buffer_words<G, XW>()];
    xb = xbuf[rb];
  }
  auto gp = grp::make<G, XW>(warp, 1 + rb, xb);
  Stage<W>& sg = stage[rb];
  const int w0 = gp.gl * C;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  Cell* out = (Cell*)bp + (size_t)r * (k_pad + 1) * W;  // row k: diagonal k
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
  *reinterpret_cast<Out*>(out + w0) = 0;
  float sc = NEG;
  int fs = 0;

  const int nq = (klast + CH - 1) / CH;
  auto stage_codes = [&](int q) {
    const int r0 = q * CH;
    const int nbytes = min(CH + 1, k_pad - r0) * W;
    for (int i = gp.gl * 16; i < nbytes; i += G * 32 * 16)
      walk::cp_async16(&sg.cd[q & 1][0][0] + i, xy + (size_t)r0 * W + i);
    walk::cp_commit();
  };
  float e[NS][C];  // emissions of the diagonal being computed
  int top = 0;     // and its top byte (band deltas)
  if (nq > 0) {
    stage_codes(0);
    cp_wait_all();
    grp::sync(gp);
    lookup<C>(emit, sg.cd[0][0], w0, e, top);
  }
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    if (q > 0) {
      cp_wait_all();  // chunk q has landed
      grp::sync(gp);   // and every lane is done with chunk q - 1's buffer
    }
    if (q + 1 < nq) stage_codes(q + 1);
    const uint8_t(*rows)[W] = sg.cd[q & 1];
    const int nk = min(CH, klast - q * CH);
#pragma unroll 4
    for (int i = 0; i < nk; ++i) {
      const int k = q * CH + i + 1;
      float en[NS][C];  // the next diagonal's, off the chain
      int topn = 0;
      lookup<C>(emit, rows[i + 1], w0, en, topn);  // stale past klast: unused
      const int d1 = (top >> 6) & 1;
      const int d2 = d1 + ((top >> 7) & 1) - 1;

      // predecessors: match from k-2 (5-way), gap states from k-1
      float v[NS][C];
      int bm[C], pa[C], pb[C];  // match argmax; weighted gap fields
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float bv = b[0][c] + tab.v[0];
        int bs = 0;
#pragma unroll
        for (int s = 1; s < NS; ++s) {
          const float cand = b[s][c] + tab.v[s * 5];
          if (cand > bv) bs = s;
          bv = fmaxf(bv, cand);
        }
        v[0][c] = bv;
        bm[c] = bs;
        int t[NS];
#pragma unroll
        for (int g = 1; g < NS; ++g) {
          if constexpr (STEP == STEP_SHORT) {
            const float from_m = a[0][c] + tab.v[g];
            const float from_g = a[g][c] + tab.v[g * 6];
            v[g][c] = fmaxf(from_m, from_g);
            t[g] = from_g > from_m;
          } else {
            float gv = a[0][c] + tab.v[g];
            int gs = 0;
#pragma unroll
            for (int s = 1; s < NS; ++s) {
              const float cand = a[s][c] + tab.v[s * 5 + g];
              if (cand > gv) gs = s;
              gv = fmaxf(gv, cand);
            }
            v[g][c] = gv;
            t[g] = STEP == STEP_FULL ? gs : gs != 0;
          }
        }
        if constexpr (STEP == STEP_FULL) {
          pa[c] = (t[1] << 3) | (t[3] << 9);
          pb[c] = (t[2] << 6) | (t[4] << 12);
        } else {
          pa[c] = 5 * t[1] + 20 * t[3];
          pb[c] = 10 * t[2] + 40 * t[4];
        }
      }
      // the cells shifted in at the warp's edges: NEG and backpointer 0
      // outside the band; across the seam, the other warp's
      float hv0 = NEG, lv0 = NEG, hv2 = NEG, hv4 = NEG, lv1 = NEG, lv3 = NEG;
      int hbm = 0, lbm = 0, hpb = 0, lpa = 0;
      if constexpr (G > 1) {
        // hi: v0, bm, v2, v4, pb from above; lo: v0, bm, v1, v3, pa from below
        const uint32_t bottom[XW] = {__float_as_uint(v[0][0]), (uint32_t)bm[0],
                                     __float_as_uint(v[2][0]), __float_as_uint(v[4][0]),
                                     (uint32_t)pb[0]};
        const uint32_t topw[XW] = {__float_as_uint(v[0][C - 1]), (uint32_t)bm[C - 1],
                                   __float_as_uint(v[1][C - 1]),
                                   __float_as_uint(v[3][C - 1]), (uint32_t)pa[C - 1]};
        const uint32_t fill[XW] = {__float_as_uint(NEG), 0u, __float_as_uint(NEG),
                                   __float_as_uint(NEG), 0u};
        uint32_t hi[XW], lo[XW];
        grp::exchange(gp, bottom, topw, fill, hi, lo);
        hv0 = __uint_as_float(hi[0]);
        lv0 = __uint_as_float(lo[0]);
        hbm = (int)hi[1];
        lbm = (int)lo[1];
        hv2 = __uint_as_float(hi[2]);
        hv4 = __uint_as_float(hi[3]);
        hpb = (int)hi[4];
        lv1 = __uint_as_float(lo[2]);
        lv3 = __uint_as_float(lo[3]);
        lpa = (int)lo[4];
      }
      // the band shifts: match by d2, then one branch for the gap pairs
      shift_sel<C>(v[0], d2, hv0, lv0, lane);
      shift_sel<C>(bm, d2, hbm, lbm, lane);
      shift_if<C, 1>(v[2], d1 != 0, hv2, lane);
      shift_if<C, 1>(v[4], d1 != 0, hv4, lane);
      shift_if<C, 1>(pb, d1 != 0, hpb, lane);
      shift_if<C, -1>(v[1], d1 == 0, lv1, lane);
      shift_if<C, -1>(v[3], d1 == 0, lv3, lane);
      shift_if<C, -1>(pa, d1 == 0, lpa, lane);

      Acc word = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          b[s][c] = a[s][c];
          a[s][c] = fmaxf(v[s][c] + e[s][c], NEG);
        }
        word |= (Acc)(bm[c] + pa[c] + pb[c]) << (8 * sizeof(Cell) * c);
      }
      *reinterpret_cast<Out*>(out + (size_t)k * W + w0) = (Out)word;
      if (k == kend) {  // cell (m, n): band cell 0 (warp 0's lane 0's)
        float ve = a[0][0];
        int se = 0;
#pragma unroll
        for (int s = 1; s < NS; ++s) {
          if (a[s][0] > ve) se = s;
          ve = fmaxf(ve, a[s][0]);
        }
        sc = ve;
        fs = se;
      }
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) e[s][c] = en[s][c];
      top = topn;
    }
  }
  // the rows past the read's end diagonal are not part of its lattice;
  // rows are W cells, and a row and the read's base are 16-byte multiples
  {
    char* p = (char*)(out + (size_t)(klast + 1) * W);
    const size_t nbytes = (size_t)(k_pad - klast) * W * sizeof(Cell);
    for (size_t i = (size_t)gp.gl * 16; i < nbytes; i += G * 32 * 16)
      *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (gp.gl == 0) {
    score[r] = sc;
    fstate[r] = fs;
  }
}

template <int C, int G>
int launch_width(int step, const Tables& t, int nreads, cudaStream_t s, const void* xyc,
                 const void* m, const void* n, int k_pad, void* score, void* fstate,
                 void* bp) {
  constexpr int R = grp::reads_per_block(G);
  constexpr int smem = dynamic_smem<C, G>();
  auto kernel = step == STEP_FULL    ? viterbi_kernel<C, STEP_FULL, G>
                : step == STEP_SHORT ? viterbi_kernel<C, STEP_SHORT, G>
                                : viterbi_kernel<C, STEP_FIVE_WAY, G>;
  if constexpr (smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(nreads + R - 1) / R, R * G * 32, smem, s>>>(
      t, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n, nreads, k_pad,
      (float*)score, (int32_t*)fstate, bp);
  return (int)cudaGetLastError();
}

template <int C, int G>
cudaError_t attrs_width(int step, cudaFuncAttributes* a, int* out) {
  out[3] = dynamic_smem<C, G>();
  out[4] = grp::reads_per_block(G) * G * 32;
  out[5] = grp::reads_per_block(G);
  return cudaFuncGetAttributes(a, step == STEP_FULL    ? viterbi_kernel<C, STEP_FULL, G>
                                  : step == STEP_SHORT ? viterbi_kernel<C, STEP_SHORT, G>
                                                  : viterbi_kernel<C, STEP_FIVE_WAY, G>);
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `tables` is host memory: the 91 log floats of ops/viterbi.py (the byte
// plane's for STEP_SHORT and STEP_FIVE_WAY, the full plane's for
// STEP_FULL).  `step`: STEP_FIVE_WAY (0) or STEP_SHORT (1) write the byte
// plane, bp (nreads, k_pad + 1, W) int8, and the caller may ask for
// STEP_SHORT only where every gap state g has t[0 -> g] > 0 or
// t[g -> g] > 0; STEP_FULL (2) writes the full plane, bp int16.  W is 32,
// 64, 128, 256, 384, 512, 768 or 1024.
extern "C" int np_viterbi_launch(const float* tables, const void* xyc, const void* m,
                                 const void* n, int nreads, int k_pad, int W,
                                 int step, void* score, void* fstate, void* bp,
                                 void* stream) {
  if (nreads <= 0 || k_pad < 1 || step < STEP_FIVE_WAY || step > STEP_FULL)
    return (int)cudaErrorInvalidValue;
  Tables t;
  for (int i = 0; i < NTAB; ++i) t.v[i] = tables[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 1024)
    return launch_width<4, 8>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 768)
    return launch_width<4, 6>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 512)
    return launch_width<4, 4>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 384)
    return launch_width<4, 3>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 256)
    return launch_width<4, 2>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 128)
    return launch_width<4, 1>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 64)
    return launch_width<2, 1>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  if (W == 32)
    return launch_width<1, 1>(step, t, nreads, s, xyc, m, n, k_pad, score, fstate, bp);
  return (int)cudaErrorInvalidValue;
}

// Registers, local memory (spill) bytes per thread, static and dynamic
// shared memory bytes per block (dynamic: the stage at W = 768 and 1024,
// static below), threads per block and reads per block of the kernel at
// band width W (`step` as for the launch), into out[6].
extern "C" int np_viterbi_attrs(int W, int step, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (step < STEP_FIVE_WAY || step > STEP_FULL)
    return (int)cudaErrorInvalidValue;
  if (W == 1024)
    e = attrs_width<4, 8>(step, &a, out);
  else if (W == 768)
    e = attrs_width<4, 6>(step, &a, out);
  else if (W == 512)
    e = attrs_width<4, 4>(step, &a, out);
  else if (W == 384)
    e = attrs_width<4, 3>(step, &a, out);
  else if (W == 256)
    e = attrs_width<4, 2>(step, &a, out);
  else if (W == 128)
    e = attrs_width<4, 1>(step, &a, out);
  else if (W == 64)
    e = attrs_width<2, 1>(step, &a, out);
  else if (W == 32)
    e = attrs_width<1, 1>(step, &a, out);
  else
    return (int)cudaErrorInvalidValue;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)e;
}
