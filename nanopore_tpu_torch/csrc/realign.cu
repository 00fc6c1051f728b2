// Fused banded pair-HMM realign: forward and backward in one kernel,
// then the reverse MEA (decode modes), the Baum-Welch sums (EM mode), the
// gamma_match band (gamma modes) or the SNP caller's expectation retire
// stream (exp mode).
//
// Replaces nanopore_tpu/ops/pairhmm_pallas_realign.py::_realign_kernel
// in its store_fwd mode, one template mode per set of outputs:
//   DECODE (emit_em=False): per read loglik, the MEA score and
//     (k_pad + 1) x W direction codes (0 diag, 1 del, 2 ins, 3 none);
//   EM (emit_em=True): per read loglik, trans (5 x 5) and emis (5 x 16)
//     expected counts.  The TPU kernel still runs the MEA DP and writes
//     the direction codes in this mode; here the EM mode does neither,
//     because the E-step has no use for (k_pad + 1) x W direction bytes
//     per read per iteration;
//   DECODE_GAMMA (emit_gamma=True): DECODE plus the gamma_match band,
//     the posterior of the match state at every band cell of every
//     diagonal, (k_pad + 1) x W f32 per read, row k = diagonal k (the
//     posterior rescore of realigned cigars);
//   GAMMA (emit_gamma=True, nothing decoded): loglik and the gamma_match
//     band only, with no MEA DP and no direction codes
//     (AlignmentUncertainty);
//   EXP (emit_exp=True): loglik, a (k_pad + 1) x 4 f32 retire stream and
//     a (4, W) f32 flush of the thresholded gamma_match binned by read
//     base (the SNP caller's per-reference-position expected base
//     counts), with no MEA DP and no direction codes.
//
// The forward runs the five-state scaled recursion along the
// anti-diagonals, rescaling every 2nd diagonal by the band maximum, with
// the log-scale in a Kahan-compensated sum, and writes every diagonal's
// states (5 x W f32) and rescale inverse to a workspace.  The backward
// runs kq..0 (rescaled on odd diagonals and diagonal 0); the posteriors
// take the forward states through the linear g-factor (clamped at 3e37,
// seeded 1/fin(k_end)), and the reverse MEA DP reads them, ties broken
// diag before del before ins.  Band shifts come from bits 6/7 of the
// codes; validity rides the sentinel code 5 (zero emission).  A band of
// live width wl < W lies in the first wl lanes of the W-lane layout, its
// dead lanes all sentinel (ops/pack.py): they hold no forward mass, the
// backward holds 0 in them (as it shifts 0 in from outside the band), the
// MEA NEG (as it shifts NEG in), and the exp mode retires column wl - 1,
// the live band's top.  So the live lanes compute what a band of width
// wl computes, bit for bit, and the dead ones add +0 to every sum.  The
// arithmetic, including its order, is the plain version's in
// ops/realign.py; this file is built with -fmad=false so no multiply and
// add fuse and the two agree to the bit.
//
// Bound: operations by the card's peak (135-182 f32 operations per band
// cell per diagonal, by mode, against 2 bytes of codes in); in fact the
// latency of each read's serial chain of diagonals, and at B = 512 (one
// read a warp scheduler) the schedulers' issue slots too.  Design shared
// by both kernels below:
//  * a lane owns C adjacent band cells in registers (C = 1, 2 or 4:
//    W = 32, 64 or 128, one warp a band), moved as one 1-, 2- or 4-cell
//    access, so a band shift is one warp shuffle.  The band maximum is
//    each lane's fmaxf over its cells, then one __reduce_max_sync over
//    the bit patterns: the states are non-negative, so their patterns
//    order as their values, and a lane whose cells are all NaN keys as
//    0, which keeps fmaxf's skipping of NaN and the "scale > 0" rule.
//  * above W = 128 a band is held by a group of G = W / 128 warps of
//    C = 4 cells a lane (the register budget of W = 128; G = 2, 3 and 4
//    at W = 256, 384 and 512), warp wg owning cells 128 wg .. 128 wg +
//    127.  Each band shift moves one cell across each seam between the
//    warps, and each band maximum meets the other warps': both pass
//    through a few words of shared memory, one named barrier for the
//    group's 32 G threads (bar.sync id, 32 G) an exchange
//    (csrc/group.cuh, seam(), band_max()).  A forward step (and a backward
//    step) is one exchange, a rescale one more, an MEA step one, an exp
//    step one.  The group stages its chunks together and syncs on the
//    same barrier.  The cells and their arithmetic are W = 128's, so
//    the bits are the plain version's.
//  * each read runs only its own diagonals, kq = m + n rounded up to even
//    (the rescale cadence keeps its parity).  Past its end a read's
//    states are zero and its g-factor 0, so the diagonals it skips would
//    change nothing (the plain version runs them all; the CPU tests hold
//    the two equal bit for bit).  The output rows past kq get what those
//    diagonals give there: 0 in the gamma band and the retire rows, 3
//    (none) in the direction codes, written with 16-byte stores.
//  * a ragged workspace: read r's slot starts woff[r] floats into the
//    launch's (a 64-bit exclusive prefix sum that the wrapper computes
//    from the host's m and n), so a launch holds what its reads need
//    rather than B x k_pad rows.  The wrapper passes the end of the last
//    read's slot too (nreads + 1 offsets), and a read whose m + n needs
//    more than its slot (a caller's m + n that disagrees with the
//    device's) traps on the device before it writes anything: never a
//    clamp.
//  * no global load on a chain: codes, stored states and rescale
//    inverses are staged through shared memory in chunks of CH diagonals
//    with cp.async, double-buffered, so the next chunk is in flight while
//    the current one is computed.  The forward looks up the emission
//    factors of the diagonal after the one it computes; the backward
//    carries them from the step before.  State stores are plain
//    coalesced stores, off the chain.
//  * the tail: a launch lasts as long as its longest read, and once the
//    short reads are done the long ones run alone (the EM batch's far-end
//    windows, the SNP caller's far-end buckets of 2-3 reads).
//  * a short step: the rescale's reciprocal is __frcp_rn (correctly
//    rounded, as 1.f / x is, so the same bits without the division's
//    slow path), and a step's four gap shifts branch once on d1.
// The model tables sit in shared memory.
//
// realign_kernel (EM, EXP): one warp per read, two reads a block (its
// staging 43,328 bytes a read at W = 128, so that width opts in to more
// than the default 48 KB of dynamic shared memory); above W = 128 one
// read a block of one group (86,592 bytes at W = 256, 129,856 at 384,
// 173,120 at 512).
// Phase A, the forward over 1..kq, stores its states (kq rows of 5 x W
// f32, row k-1 = diagonal k) and then its rescale inverses (kq + 1
// floats, padded to 16 bytes) in the read's slot; phase B streams them
// back in descending order beside the backward.
// Above W = 512 (G = 6 and 8 warps: W = 768 and 1024) it runs every
// mode (two_phase): the layouts below do not fit an SM there (mea_kernel
// 3 G warps at ~160 registers, 92,160 and 122,880 registers a block; its
// stage ~432 W bytes).  Phase B then also forms, from the same g_k and
// posteriors, mea_kernel's MEA step (DECODE, DECODE_GAMMA) with the same
// operations in the same order, and stores the gamma row (DECODE_GAMMA,
// GAMMA; gamma_kernel's (f * b) * g); the states it reads are the ones
// mea_kernel recomputes and gamma_kernel stores, bit for bit, so every
// mode's outputs are the plain version's at any G.  Its chunk is 4
// diagonals there (realign_chunk: 130,592 and 174,112 bytes a block; 8
// would take 327,680 of states at 1024, past the 232,448 a block may
// opt into), and the decode and gamma modes keep this slot: no
// checkpoints, no backward scales.
//
// mea_kernel (DECODE, DECODE_GAMMA): one read a block of 3 warps.  The
// backward recursion does not read the forward; only the posteriors and
// the MEA do.  So the two chains run side by side and the MEA pass is
// fed by recompute:
//  * phase 1: warp 0 runs the forward (as phase A above); warp 1 runs the
//    backward recursion alone over kq..0 and stores its scale `safe` at
//    every diagonal (kq + 1 floats, after sf) and, at the top of every
//    segment of S diagonals (diagonals jS .. jS + S - 1, the top one
//    holding kq), the states it carries into that diagonal: b1 and the
//    match state of b2 (6 x W f32, the checkpoint of segment j); warp 2
//    writes the rows past kq.  One block barrier.
//  * phase 2: warp 0 walks kq..0 once more: it stages the forward rows,
//    codes, sf and safe with cp.async and takes the backward states of
//    each segment from a ring of NSLOT shared-memory slots, then forms
//    g_k, the posteriors, the MEA carry and the direction word (and the
//    gamma row) as phase B does.  Warps 1 and 2 recompute the segments
//    from their checkpoints, alternating, in descending order, each into
//    the next ring slot: the emissions and band deltas come from the
//    codes (staged per segment with cp.async), the carried rescale
//    inverse is 1 / safe of the diagonal above, and the checkpoint for a
//    producer's next segment is loaded into registers while it computes
//    this one.  Slots pass between them with mbarrier arrive (release)
//    and try_wait.parity (acquire), a full and an empty barrier a slot.
//  The recomputed states are the stored ones bit for bit (the same
//  operations on the same floats), so the outputs are the one-warp
//  kernel's.  The chain becomes kq x max(t_f, t_b) + kq x max(t_mea,
//  t_b / 2) in place of kq x (t_f + t_b + t_mea), for two more warps a
//  read and the backward's instructions twice.  Shared memory: 54,960
//  bytes a block at W = 64 (27,568 at W = 32), so four reads fit a SM
//  (132 x 4 = 528 >= 512), with __launch_bounds__(96, 4) holding the
//  registers to 168; 110,120 at W = 128, so two fit (264 reads at once)
//  and the bound is (96, 2), which leaves the registers at 255.  Above
//  W = 128 each role is a group of G warps (a block of 3 G warps, a
//  slot's full and empty barriers take 32 G arrivals) and the stage
//  takes 219,312 bytes at W = 256, one block an SM.  At W = 384 and 512
//  a segment (and phase 2's chunk) of 8 diagonals would not fit (the
//  stage grows as ~856 W bytes: 438,272 at 512), so there it is 4
//  diagonals (~432 W: 165,984 and 221,296 bytes; mea_segment); the
//  recomputed states do not depend on it, so neither do the outputs.
//  The block of 12 warps at W = 512 caps a thread at 168 registers.
//  Workspace per read: the forward's states and sf, then safe, then
//  kq / S + 1 checkpoints (S the segment).
//
// gamma_kernel (GAMMA): one read a block of 4 warps (4 groups of G above
// W = 128, 3 at W = 512, whose 16 warps would cap a thread at 128
// registers: the chains are groups, the g chain stays on warp 0, the
// other roles write the rows past kq).  The band needs, of
// each diagonal, only the forward's and the backward's match states and
// one scalar g_k, so neither chain waits for the other and the product
// comes last, over every cell at once:
//  * phase 1: warp 0 runs the forward (as phase A) but stores only its
//    match state, straight into the read's rows of the gamma band (row 0:
//    diagonal 0's), with sf, the loglik and fin(k_end); warp 1 runs the
//    backward recursion over kq..0 and stores its match state (after the
//    end-cell overwrite and the rescale) and its scale `safe` at every
//    diagonal into the read's slot; warps 2 and 3 write the band rows past
//    kq.  One block barrier.
//  * the g chain: g_k = min(k == k_end ? 1 / fin : (g_{k+1} sf_{k+1})
//    safe_k, 3e37) over kq..0, one serial scalar recursion (the clamp makes
//    it non-associative), run by warp 0 with the scales of 32 diagonals a
//    coalesced load, the next 32 in flight, each passed along by shuffles;
//    g_k overwrites safe_k.  One block barrier.
//  * phase 2: every warp forms gamma = (f * b) * g_k in place in the band,
//    16 bytes a load and a store, four in flight a thread: the same three
//    floats in the same order as the fused step, so the same bits.
//  The chain becomes kq x max(t_f, t_b) plus ~kq scalar steps plus a pass
//  at memory speed (reads f and b, writes gamma: 3 x (kq + 1) x W x 4
//  bytes), in place of kq x (t_f + t_b).  Workspace per read: (kq + 1) x W
//  f32 match rows, then sf and safe, about a fifth of the 5-state slot.
//
// EM mode adds 57 accumulators per lane (25 transition products, 16
// match bins, 2 x 4 delete bins by the x code, 2 x 4 insert bins by the
// y code): a lane adds its C cells into one register per count, so the
// register cost is 57 at any width, and the 32 G lanes are summed after
// the last diagonal: at G > 1 the warps first fold onto warp 0 through
// shared memory, the upper ceil(G / 2) onto the lower, lane for lane
// (at G = 2 and 4 the xor butterfly's steps across warps; at G = 3 warp
// 2 onto warp 0, then warp 1), then one warp's xor butterfly; the
// transition sums take their tf factor only then.  Binning is a predicated add per bin (a select
// and an add, 32 per cell): a dynamically indexed register array would go
// to local memory.  Only codes 0-3 bin; N = 4 and the sentinel 5 bin
// nowhere.  The backward then does about 79 - 13 + 5 + 50 + 32 = 153 f32
// operations per cell against decode mode's 79 (no MEA, 5 + 50 for the
// transition products, one add per bin).
//
// The gamma modes store gamma[0] of every band cell of every diagonal,
// diagonal 0 included: the very value the MEA reads, under the same
// g-factor, 3e37 clamp and rescale cadence.  The band is (B, k_pad + 1, W)
// batch-major, (k_pad + 1) * W * 4 bytes a read, and lives beside the
// workspace (the wrapper's sub-batches share one workspace; the band is
// the whole batch's).
//
// The exp mode follows the band down the diagonals with 4 accumulators
// per band cell (4 C registers a lane), in diagonal k's band coordinates.
// On the k+1 -> k step it first emits column wl - 1 (the top of the live
// band: at wl = W the last lane's last cell; reference position
// o[k+1] + wl - 2) times d1[k+1] as retire row k, then moves every column
// up by d1[k+1] (the band shift's warp shuffle, as a + d1 * (a[w-1] - a)
// with 0 shifted in) and zeroes the columns at and above wl, so nothing
// is carried out of the live band, then adds gamma[0] where
// it is above the threshold, times the one-hot of the cell's read base
// (code bits 0-2: 0-3 bin, N = 4 and the sentinel 5 nowhere; diagonal 0
// holds sentinels only).  After diagonal 0 the surviving columns are the
// flush (positions w - 1).  Blend, threshold and binning are written as
// the TPU kernel writes them (a multiply by a 0/1 factor), so a
// non-finite gamma spreads as it does there.  The threshold is the 94th
// table entry, passed by value.
#include <cuda_runtime.h>
#include <stdint.h>

#include "group.cuh"

namespace {

constexpr int NS = 5;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 2;  // warps a block of realign_kernel: a read each, or a pair's read
constexpr int CH = 8;     // diagonals per staged chunk (even: the forward steps in pairs)
constexpr int S = 8;      // diagonals per segment of mea_kernel's backward
constexpr int NSLOT = 3;  // ring slots of mea_kernel: two producers need three
constexpr int MEA_WARPS = 3;  // roles of mea_kernel (a warp each, or a group each)
// mea_kernel's blocks an SM: as many as its shared memory lets in (four
// at W <= 64, two at W = 128, one above), the register cap of
// __launch_bounds__
constexpr int mea_blocks(int C, int G) { return G > 1 ? 1 : (C == 4 ? 2 : 4); }
// mea_kernel's segment (and phase 2's chunk): S, but half of it above
// W = 256, where a stage of S-diagonal chunks would not fit a block
__host__ __device__ constexpr int mea_segment(int G) { return G > 2 ? S / 2 : S; }
constexpr int GAMMA_WARPS = 4;  // roles of gamma_kernel (a warp each, or a group each)
// gamma_kernel's roles: three at G = 4, whose block of 16 warps would cap
// a thread at 128 registers (the two chains and one writer of the rows
// past kq; the product pass takes every warp either way)
__host__ __device__ constexpr int gamma_roles(int G) { return G > 3 ? 3 : GAMMA_WARPS; }
// warps a block of realign_kernel: WARPS, or one group of G > WARPS
__host__ __device__ constexpr int realign_warps(int G) { return G > WARPS ? G : WARPS; }
// above W = 512 (G = 6 and 8) every mode runs realign_kernel's two
// phases on one group: mea_kernel's 3 G warps and gamma_kernel's 3 to 4 G
// would not fit an SM's registers (18 / 24 warps at 160 a thread)
__host__ __device__ constexpr bool two_phase(int G) { return G > 4; }
// realign_kernel's chunk: CH diagonals, but half of it above W = 512,
// where a Stage of CH (327,680 bytes of states at W = 1024) would not
// fit a block; even either way, as the forward steps in pairs
__host__ __device__ constexpr int realign_chunk(int G) { return two_phase(G) ? CH / 2 : CH; }
constexpr int XA = 8;           // arrays one seam exchange carries at most
static_assert(S == CH, "mea_kernel's consumer stages one chunk per segment");
// tf 25 | emf 36 | egf 30 | gap gamma | match gamma | exp threshold
constexpr int NTAB = 94;
// kernel modes (the ``mode`` argument of np_realign_launch)
constexpr int DECODE = 0, EM_MODE = 1, GAMMA = 2, DECODE_GAMMA = 3, EXP = 4;

struct Tables {
  float v[NTAB];
};

// The warps that hold one read's band (csrc/group.cuh): G warps (G =
// W / 128 above W = 128, else 1), on CB blocks of a cluster (CB = 2 at
// W = 1536 and 2048, G = 6 and 8 a block); a seam exchange carries a
// lane 0's first cell and a lane 31's last cell of at most XA arrays.
template <int G, int CB = 1>
using Grp = grp::Group<G, XA, CB>;

// One Stage a read in realign_kernel, staged by the read's warps, in
// chunks of K diagonals (realign_chunk).  Chunk q of phase A holds the
// code rows of diagonals q*K + 1 .. q*K + K + 1 (row i: diagonal q*K +
// i + 1); chunk q of phase B holds, in slot s, the forward states and
// codes of diagonal q*K + s and sf[q*K + s + 1].
template <int W, int K = CH>
struct __align__(16) Stage {
  float st[2][K][NS * W];
  uint8_t cd[2][K + 1][W];
  float sf[2][K];
};

// mea_kernel's shared memory: phase 1's code buffers and phase 2's
// buffers share the space (a block barrier lies between).  Phase 2's
// chunk q is segment q of MS diagonals (mea_segment): slot s holds
// diagonal q*MS + s, with sf of the diagonal above and safe of its own;
// a ring slot holds a segment's recomputed backward states, row s
// diagonal j*MS + s; a producer's code buffer row i holds diagonal
// j*MS + i, i < MS + 2 (its carry reads the two diagonals above the
// segment).  Phase 1 stages chunks of CH diagonals at every width.
template <int W, int MS>
struct __align__(16) MeaStage {
  union {
    struct {
      uint8_t fcd[2][CH + 1][W];  // the forward's codes
      uint8_t bcd[2][CH][W];      // the backward's codes
    } p1;
    struct {
      float st[2][MS][NS * W];
      float ring[NSLOT][MS][NS * W];
      uint8_t cd[2][MS][W];
      uint8_t pcd[2][2][MS + 2][W];  // [producer][buffer][row]
      float sf[2][MS];
      float sa[2][MS];
    } p2;
  } u;
  unsigned long long full[NSLOT], empty[NSLOT];
};

// gamma_kernel's shared memory: the forward's and the backward's code
// chunks (as forward_pass and mea_kernel's backward stage them)
template <int W>
struct __align__(16) GammaStage {
  uint8_t fcd[2][CH + 1][W];
  uint8_t bcd[2][CH][W];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this lane's copies; the caller's group barrier then shows
// every lane's copies to the group
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// nbytes (a multiple of 16) from global src to shared dst, 16 bytes a
// copy, by thread t of nt
__device__ __forceinline__ void warp_copy(void* dst, const void* src, int nbytes, int t,
                                          int nt = 32) {
  for (int i = t * 16; i < nbytes; i += nt * 16)
    cp_async16((char*)dst + i, (const char*)src + i);
}

// nrows rows of row_bytes (a multiple of 16) from global src, src_stride
// bytes apart, to consecutive rows of shared dst, 16 bytes a copy, by
// thread t of nt: a block's columns of a band's rows (the cluster tier)
template <int row_bytes>
__device__ __forceinline__ void rows_copy(void* dst, const void* src, int nrows,
                                          size_t src_stride, int t, int nt) {
  for (int i = t * 16; i < nrows * row_bytes; i += nt * 16)
    cp_async16((char*)dst + i, (const char*)src + (size_t)(i / row_bytes) * src_stride +
                                   i % row_bytes);
}

// shared-memory barriers of mea_kernel's ring (one arrival a lane)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// arrive with release semantics: this lane's earlier shared-memory
// accesses are ordered before the phase completes
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait (acquire) until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// rows kq + 1 .. k_pad of one read's (k_pad + 1) x row_bytes output, each
// 4-byte word set to `word`, by thread t of nt; row_bytes and the row
// starts are 16-byte multiples
__device__ __forceinline__ void fill_rows(void* base, int kq, int k_pad, int row_bytes,
                                          uint32_t word, int t, int nt = 32) {
  char* p = (char*)base + (size_t)(kq + 1) * row_bytes;
  const size_t nbytes = (size_t)(k_pad - kq) * row_bytes;
  const uint4 v = make_uint4(word, word, word, word);
  for (size_t i = (size_t)t * 16; i < nbytes; i += (size_t)nt * 16)
    *reinterpret_cast<uint4*>(p + i) = v;
}

// The cells across the seams of N arrays (a lane's C cells each):
// hi[i], the cell above a[i]'s last (for the warp's lane 31: the next
// warp's lane 0's first cell, `fill` above the group's top warp), and
// lo[i], the cell below a[i]'s first (for lane 0: the previous warp's
// lane 31's last cell, `fill` below warp 0).  One exchange at G > 1.
template <int C, int G, int N, int CB>
__device__ __forceinline__ void seam(Grp<G, CB>& g, const float (&a)[N][C], float fill,
                                     float (&hi)[N], float (&lo)[N]) {
  if constexpr (G == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) hi[i] = lo[i] = fill;
  } else {
    float bottom[N], top[N], f[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      bottom[i] = a[i][0];
      top[i] = a[i][C - 1];
      f[i] = fill;
    }
    grp::exchange(g, bottom, top, f, hi, lo);
  }
}

// out[w] = a[w + s] for a warp-uniform s in {-1, 0, 1}; at the warp's
// top `hi` comes in (s = 1), at its bottom `lo` (s = -1): the fill at
// the band's edges, the neighbouring warp's cell at a seam (seam()).
template <int C>
__device__ __forceinline__ void shift(const float (&a)[C], float (&o)[C], int s, float hi,
                                      float lo, int lane) {
  if (s == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = a[c];
  } else if (s > 0) {
    const float nb = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) o[c] = a[c + 1];
    o[C - 1] = lane == 31 ? hi : nb;
  } else {
    const float nb = __shfl_up_sync(FULL, a[C - 1], 1);
#pragma unroll
    for (int c = C - 1; c > 0; --c) o[c] = a[c - 1];
    o[0] = lane == 0 ? lo : nb;
  }
}

// out[w] = a[w + SH] for a compile-time SH in {-1, 1}; `hi` or `lo` in
// as shift() takes them.
template <int C, int SH>
__device__ __forceinline__ void shift_by(const float (&a)[C], float (&o)[C], float hi,
                                         float lo, int lane) {
  if constexpr (SH > 0) {
    const float nb = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) o[c] = a[c + 1];
    o[C - 1] = lane == 31 ? hi : nb;
  } else {
    const float nb = __shfl_up_sync(FULL, a[C - 1], 1);
#pragma unroll
    for (int c = C - 1; c > 0; --c) o[c] = a[c - 1];
    o[0] = lane == 0 ? lo : nb;
  }
}

// The four gap destinations' shifts, one warp-uniform branch on d1: by
// (d1 - 1, d1, d1 - 1, d1) where `up` (the forward), by (1 - d1, -d1,
// 1 - d1, -d1) otherwise (the backward), as four calls of shift give;
// hi and lo are seam()'s over the five arrays.
template <int C, bool UP>
__device__ __forceinline__ void gap_shifts(const float (&a)[NS][C], float (&o)[NS][C], int d1,
                                           const float (&hi)[NS], const float (&lo)[NS],
                                           int lane) {
  constexpr int SH = UP ? 1 : -1;
  if (d1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      o[1][c] = a[1][c];
      o[3][c] = a[3][c];
    }
    shift_by<C, SH>(a[2], o[2], hi[2], lo[2], lane);
    shift_by<C, SH>(a[4], o[4], hi[4], lo[4], lane);
  } else {
    shift_by<C, -SH>(a[1], o[1], hi[1], lo[1], lane);
    shift_by<C, -SH>(a[3], o[3], hi[3], lo[3], lane);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      o[2][c] = a[2][c];
      o[4][c] = a[4][c];
    }
  }
}

// 1 / x, correctly rounded as the division is, without its slow path
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// The band maximum as fmaxf gives it: the states are non-negative, so
// their bit patterns order as their values; a lane whose cells are all
// NaN keys as 0 (fmaxf skips NaN, and a NaN or 0 maximum both mean
// "no scale" to the caller).  At G > 1 the warps' maxima meet in one
// exchange (the largest key of any order of them).
template <int C, int G, int CB>
__device__ __forceinline__ float band_max(const float (&v)[NS][C], Grp<G, CB>& g) {
  float mx = v[0][0];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, v[s][c]);
  const int key = mx == mx ? __float_as_int(mx) : 0;
  return __int_as_float(grp::max(g, __reduce_max_sync(FULL, key)));
}

// group lane 0's value to every lane of the group (every lane calls)
template <int G, int CB>
__device__ __forceinline__ float from_lane0(float v, Grp<G, CB>& g) {
  return grp::from_lane0(g, v);
}

// sum_s tf[s*5 + dest] * p[s], each product and sum rounded on its own
template <int C>
__device__ __forceinline__ void trans_sum(const float* tf, const float (&p)[NS][C],
                                          int dest, float (&o)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = tf[dest] * p[0][c];
#pragma unroll
    for (int s = 1; s < NS; ++s) acc = acc + tf[s * 5 + dest] * p[s][c];
    o[c] = acc;
  }
}

// A lane's C adjacent cells move as one access of C bytes of codes or
// C floats (aligned to its size: w0 = (group lane) * C, and every row
// starts at a multiple of 16 bytes).
template <int C>
__device__ __forceinline__ void load_codes(const uint8_t* row, int w0, uint8_t (&c)[C]) {
  if constexpr (C == 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(row + w0);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = (uint8_t)(v >> (8 * i));
  } else if constexpr (C == 2) {
    const uint16_t v = *reinterpret_cast<const uint16_t*>(row + w0);
    c[0] = (uint8_t)(v & 0xFF);
    c[1] = (uint8_t)(v >> 8);
  } else {
    c[0] = row[w0];
  }
}

// one band row of direction codes: byte c of `word` is cell c's
template <int C>
__device__ __forceinline__ void store_codes(int8_t* row, int w0, uint32_t word) {
  if constexpr (C == 4) {
    *reinterpret_cast<uint32_t*>(row + w0) = word;
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(row + w0) = (uint16_t)word;
  } else {
    row[w0] = (int8_t)word;
  }
}

// one band row of f32 (a lane's C cells)
template <int C>
__device__ __forceinline__ void load_row(const float* row, int w0, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(row + w0);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + w0);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = row[w0];
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* row, int w0, const float (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(row + w0) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(row + w0) = make_float2(v[0], v[1]);
  } else {
    row[w0] = v[0];
  }
}

// the five states of a lane's cells: row s of W floats each
template <int C, int W>
__device__ __forceinline__ void load_states(const float* row, int w0, float (&f)[NS][C]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) load_row<C>(row + s * W, w0, f[s]);
}

template <int C, int W>
__device__ __forceinline__ void store_states(float* row, int w0, const float (&f)[NS][C]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) store_row<C>(row + s * W, w0, f[s]);
}

// emission factors [e_m, gx1, gy2, gx3, gy4] of a lane's cells
template <int C>
__device__ __forceinline__ void emissions(const float* emf, const float* egf,
                                          const uint8_t (&code)[C], float (&e)[NS][C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = (code[c] >> 3) & 7;
    const int y = code[c] & 7;
    e[0][c] = emf[x * 6 + y];
    e[1][c] = egf[6 + x];
    e[2][c] = egf[12 + y];
    e[3][c] = egf[18 + x];
    e[4][c] = egf[24 + y];
  }
}

// One forward anti-diagonal: nw from prev (k-1) and pp (k-2, scaled by r),
// with the diagonal's emission factors e looked up beforehand.
template <int C, int G, int CB>
__device__ __forceinline__ void fwd_step(const float* tf, const float (&e)[NS][C], int d1,
                                         int d2, const float (&prev)[NS][C],
                                         const float (&pp)[NS][C], float r,
                                         float (&nw)[NS][C], Grp<G, CB>& g) {
  float t[NS][C], sh[NS][C], hi[NS], lo[NS];
  trans_sum<C>(tf, pp, 0, t[0]);
#pragma unroll
  for (int d = 1; d < NS; ++d) trans_sum<C>(tf, prev, d, t[d]);
  seam<C, G, NS>(g, t, 0.f, hi, lo);
  shift<C>(t[0], sh[0], d2, hi[0], lo[0], g.lane);
  gap_shifts<C, true>(t, sh, d1, hi, lo, g.lane);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    nw[0][c] = e[0][c] * (sh[0][c] * r);
#pragma unroll
    for (int s = 1; s < NS; ++s) nw[s][c] = e[s][c] * sh[s][c];
  }
}

// loglik bookkeeping at the read's end diagonal (band-start mass, group
// lane 0)
template <int C, int G, int CB>
__device__ __forceinline__ void end_check(int k, int kend, const float (&nw)[NS][C],
                                          float ls_hi, float ls_c, float& acc,
                                          float& fin_end, Grp<G, CB>& g) {
  if (k != kend) return;  // group-uniform
  float fin = nw[0][0];
#pragma unroll
  for (int s = 1; s < NS; ++s) fin = fin + nw[s][0];
  fin = from_lane0<G>(fin, g);
  fin_end = fmaxf(fin, 1e-37f);
  acc = acc + (logf(fin_end) + (ls_hi - ls_c));
}

// The forward over diagonals 1..kq: stores row k-1 of `fs` (diagonal k's
// states; with MATCH, row k of `fs` holds diagonal k's match state alone)
// and sf[k] (even k's rescale inverse), returns the loglik in `acc` and
// the band-start mass at kend in `fin_end`.  `cd` is the group's two code
// chunks of K + 1 rows (row i of chunk q: diagonal q*K + i + 1, the
// one-ahead emission lookup).  At CB > 1 the band is the cluster's: a
// block stages and computes its own 32 C G columns (a lane's column in
// them its band cell less the block's first), stores them into the
// band's rows, and rank 0 stores sf.  The CB > 1 code lies in discarded
// branches at CB = 1 and declares nothing outside them (one more local,
// even a constexpr one, renumbers the compiler's registers), so the
// CB = 1 builds keep their machine code.
template <int C, int G, bool MATCH = false, int K = CH, int CB = 1>
__device__ __forceinline__ void forward_pass(const float* tf, const float* emf,
                                             const float* egf,
                                             uint8_t (*cd)[K + 1][32 * C * G],
                                             const uint8_t* xy, int k_pad, int kq, int kend,
                                             float* fs, float* sf, Grp<G, CB>& g, float& acc,
                                             float& fin_end) {
  constexpr int W = 32 * C * G * CB;  // the band's (a block's: 32 C G)
  static_assert(K % 2 == 0, "the forward steps in pairs of diagonals");
  const int w0 = g.gl * C;
  float a[NS][C], b[NS][C];  // diagonals k0 (even) and k0 - 1
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a[s][c] = (w0 + c == 0) ? 1.0f / 5.0f : 0.f;
      b[s][c] = 0.f;
    }
  float ls_hi = 0.f, ls_c = 0.f, rs = 1.f;
  const int nqa = (kq + K - 1) / K;
  auto stage_codes = [&](int q) {
    const int r0 = q * K;
    if constexpr (CB == 1)
      warp_copy(cd[q & 1][0], xy + (size_t)r0 * W, min(K + 1, k_pad - r0) * W, g.gl, 32 * G);
    else  // the block's columns, by the block's threads
      rows_copy<32 * C * G>(cd[q & 1][0], xy + (size_t)r0 * W + grp::rank(g) * 32 * C * G,
                            min(K + 1, k_pad - r0), W, g.gl - grp::rank(g) * 32 * G, 32 * G);
    cp_commit();
  };
  float ea[NS][C];  // emission factors of the next odd diagonal
  if (nqa > 0) {
    stage_codes(0);
    cp_wait_all();
    grp::sync(g);
    uint8_t c0[C];
    if constexpr (CB == 1)
      load_codes<C>(cd[0][0], w0, c0);
    else
      load_codes<C>(cd[0][0], w0 - grp::rank(g) * 32 * C * G, c0);
    emissions<C>(emf, egf, c0, ea);
  }
#pragma unroll 1
  for (int q = 0; q < nqa; ++q) {
    if (q > 0) {
      cp_wait_all();  // chunk q has landed
      grp::sync(g);    // and every lane is done with chunk q - 1's buffer
    }
    if (q + 1 < nqa) stage_codes(q + 1);
    const uint8_t(*rows)[32 * C * G] = cd[q & 1];
    const int nk = min(K, kq - q * K);
    for (int i = 0; i < nk; i += 2) {
      const int k0 = q * K + i;  // diagonals k0 + 1 (odd) and k0 + 2 (even)
      uint8_t cb[C], cc[C];
      if constexpr (CB == 1) {
        load_codes<C>(rows[i + 1], w0, cb);
        load_codes<C>(rows[i + 2], w0, cc);
      } else {
        load_codes<C>(rows[i + 1], w0 - grp::rank(g) * 32 * C * G, cb);
        load_codes<C>(rows[i + 2], w0 - grp::rank(g) * 32 * C * G, cc);
      }
      float eb[NS][C], ec[NS][C];
      emissions<C>(emf, egf, cb, eb);
      // odd diagonal k0 + 1: no rescale
      int top = rows[i][0];
      int d1 = (top >> 6) & 1, d1p = (top >> 7) & 1;
      float nb[NS][C];
      fwd_step<C, G>(tf, ea, d1, d1 + d1p - 1, a, b, rs, nb, g);
      end_check<C, G>(k0 + 1, kend, nb, ls_hi, ls_c, acc, fin_end, g);
      if constexpr (MATCH)
        store_row<C>(fs + (size_t)(k0 + 1) * W, w0, nb[0]);
      else
        store_states<C, W>(fs + (size_t)k0 * NS * W, w0, nb);
      emissions<C>(emf, egf, cc, ec);
      // even diagonal k0 + 2: rescale by the band maximum
      top = rows[i + 1][0];
      d1 = (top >> 6) & 1;
      d1p = (top >> 7) & 1;
      float na[NS][C];
      fwd_step<C, G>(tf, eb, d1, d1 + d1p - 1, nb, a, 1.f, na, g);
      const float scale = band_max<C, G>(na, g);
      const float safe = scale > 0.f ? scale : 1.f;
      const float inv = recip(safe);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) na[s][c] = na[s][c] * inv;
      {  // Kahan-compensated log-scale: value = ls_hi - ls_c
        const float y = logf(safe) - ls_c;
        const float t = ls_hi + y;
        ls_c = (t - ls_hi) - y;
        ls_hi = t;
      }
      end_check<C, G>(k0 + 2, kend, na, ls_hi, ls_c, acc, fin_end, g);
      if constexpr (MATCH)
        store_row<C>(fs + (size_t)(k0 + 2) * W, w0, na[0]);
      else
        store_states<C, W>(fs + (size_t)(k0 + 1) * NS * W, w0, na);
      if (g.gl == 0) sf[k0 + 2] = inv;
      rs = inv;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          b[s][c] = nb[s][c];
          a[s][c] = na[s][c];
          ea[s][c] = ec[s][c];
        }
    }
  }
}

// What the backward carries down to diagonal k: the states of k+1 and
// the match state of k+2 (the only one of k+2 a step reads), the
// emissions of k+1 (and k+2's match emission), the band deltas of k+1
// and k+2 and k+1's rescale inverse.  Past kq all are zero (binv one).
template <int C>
struct Bwd {
  float b1[NS][C], b2m[C];
  float em1[C], em2[C], ex1[C], ex3[C], ey2[C], ey4[C];
  float binv;
  int d1n1, d1n2;
};

template <int C>
__device__ __forceinline__ void bwd_init(Bwd<C>& bw) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int s = 0; s < NS; ++s) bw.b1[s][c] = 0.f;
    bw.b2m[c] = 0.f;
    bw.em1[c] = bw.em2[c] = bw.ex1[c] = bw.ex3[c] = bw.ey2[c] = bw.ey4[c] = 0.f;
  }
  bw.binv = 1.f;
  bw.d1n1 = bw.d1n2 = 0;
}

// One backward anti-diagonal k: `dest`, the emission-weighted states of
// k+1 and k+2 shifted onto k (before the end-cell overwrite), `nw` (0 in
// the dead lanes, at and above the live width wl) and, on odd k and on
// k = 0, the rescale by its band maximum `safe` (nw comes out rescaled;
// safe and inv are 1 on the other diagonals).
template <int C, int G, int CB>
__device__ __forceinline__ void bwd_step(const float* tf, const Bwd<C>& bw, int k,
                                         bool is_end, Grp<G, CB>& g, int wl,
                                         float (&dest)[NS][C], float (&nw)[NS][C],
                                         float& safe, float& inv) {
  const int w0 = g.gl * C;
  const int d2n2 = bw.d1n1 + bw.d1n2 - 1;
  float p[NS][C], hi[NS], lo[NS];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[0][c] = bw.b2m[c] * bw.em2[c];
    p[1][c] = bw.b1[1][c] * bw.ex1[c];
    p[2][c] = bw.b1[2][c] * bw.ey2[c];
    p[3][c] = bw.b1[3][c] * bw.ex3[c];
    p[4][c] = bw.b1[4][c] * bw.ey4[c];
  }
  seam<C, G, NS>(g, p, 0.f, hi, lo);
  shift<C>(p[0], dest[0], -d2n2, hi[0], lo[0], g.lane);
  gap_shifts<C, false>(p, dest, bw.d1n1, hi, lo, g.lane);
#pragma unroll
  for (int c = 0; c < C; ++c) dest[0][c] = dest[0][c] * bw.binv;
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc_t = tf[st * 5] * dest[0][c];
#pragma unroll
      for (int t = 1; t < NS; ++t) acc_t = acc_t + tf[st * 5 + t] * dest[t][c];
      const float v = is_end ? ((w0 + c == 0) ? 1.f : 0.f) : acc_t;
      nw[st][c] = w0 + c < wl ? v : 0.f;
    }
  safe = 1.f;
  inv = 1.f;
  if ((k & 1) || k == 0) {
    const float scale = band_max<C, G>(nw, g);
    safe = scale > 0.f ? scale : 1.f;
    inv = recip(safe);
#pragma unroll
    for (int st = 0; st < NS; ++st)
#pragma unroll
      for (int c = 0; c < C; ++c) nw[st][c] = nw[st][c] * inv;
  }
}

// the emissions and band delta of diagonal k (codes ck, top byte `top`)
// move into the carry as those of k+1, the old ones as k+2's
template <int C>
__device__ __forceinline__ void bwd_codes(Bwd<C>& bw, const float* emf, const float* egf,
                                          const uint8_t (&ck)[C], int top) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = (ck[c] >> 3) & 7;
    const int y = ck[c] & 7;
    bw.em2[c] = bw.em1[c];
    bw.em1[c] = emf[x * 6 + y];
    bw.ex1[c] = egf[6 + x];
    bw.ey2[c] = egf[12 + y];
    bw.ex3[c] = egf[18 + x];
    bw.ey4[c] = egf[24 + y];
  }
  bw.d1n2 = bw.d1n1;
  bw.d1n1 = (top >> 6) & 1;
}

// carry down to diagonal k - 1 after computing diagonal k (k >= 1)
template <int C>
__device__ __forceinline__ void bwd_carry(Bwd<C>& bw, const float (&nw)[NS][C], float inv,
                                          const float* emf, const float* egf,
                                          const uint8_t (&ck)[C], int top) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bw.b2m[c] = bw.b1[0][c];
#pragma unroll
    for (int st = 0; st < NS; ++st) bw.b1[st][c] = nw[st][c];
  }
  bwd_codes<C>(bw, emf, egf, ck, top);
  bw.binv = inv;
}

// acc += value where the cell's bin is `bin`, for each of N bins
template <int N>
__device__ __forceinline__ void bin_add(float* acc, int bin, float value) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] + (bin == i ? value : 0.f);
}

// Outputs by mode:
//   EM: `out1` trans (B, 25), `out2` emis (B, 80) f32;
//   EXP: `out1` retire rows (B, k_pad + 1, 4), `out2` flush (B, 4, W) f32;
//   above W = 512 (two_phase), the decode modes mea_kernel's (`out1` the
//   MEA score, `out2` the direction codes, `out3` in DECODE_GAMMA the
//   gamma band) and GAMMA gamma_kernel's (`out3` the gamma band).
// `ws` is the launch's workspace and `woff[r]` read r's offset in it
// (floats), woff[r + 1] the end of its slot; dynamic shared memory holds
// one Stage<W, realign_chunk(G)> a read of the block (realign_warps(G) /
// G reads).
// At CB > 1 (W = 1536 and 2048: G = 6 and 8 warps a block, two_phase)
// read r is held by cluster r, of CB blocks on CB SMs (csrc/group.cuh's
// cluster tier): each block stages and computes its own 32 C G columns,
// its Stage<32 C G, 4> that of the W = 768 or 1024 build; the read's
// slot holds the whole band's states (the blocks write their own
// columns), then the rescale inverses, which rank 0 writes (the rescale
// is the cluster's band maximum); every exchange, band maximum and sync
// is a cluster barrier.  The EM sums first fold the upper blocks' warps
// onto the lower blocks', lane for lane, through distributed shared
// memory (at CB = 2 block 1's onto block 0's: the fold's first step over
// the 2 G warps), then block 0 folds as the one-block build.  Rank 0
// writes the per-read scalars (loglik, the MEA score, the EM tables),
// and no block leaves before its partner can no longer read its shared
// memory (one cluster barrier last).
template <int C, int G, int MODE, int CB = 1>
__global__ void __launch_bounds__(realign_warps(G) * 32)
realign_kernel(Tables tab, const uint8_t* __restrict__ xyc, const int32_t* __restrict__ m,
               const int32_t* __restrict__ n, int nreads, int k_pad, int wl,
               float* __restrict__ ws, const int64_t* __restrict__ woff,
               float* __restrict__ loglik, float* __restrict__ out1,
               void* __restrict__ out2, float* __restrict__ out3) {
  constexpr int W = 32 * C * G * CB;        // the band's (a block's: 32 C G)
  constexpr int K = realign_chunk(G);       // diagonals a staged chunk
  constexpr int RB = realign_warps(G) / G;  // reads a block
  constexpr bool EM = MODE == EM_MODE;
  constexpr bool XP = MODE == EXP;
  constexpr bool MEA = MODE == DECODE || MODE == DECODE_GAMMA;
  constexpr bool GAM = MODE == GAMMA || MODE == DECODE_GAMMA;
  static_assert(EM || XP || two_phase(G),
                "up to W = 512 the decode modes run mea_kernel, the gamma mode gamma_kernel");
  static_assert(RB * G == realign_warps(G), "a block holds whole groups");
  static_assert(CB == 1 || (two_phase(G) && RB == 1), "a cluster holds one read");
  __shared__ float sm[NTAB];
  extern __shared__ __align__(16) unsigned char stage_raw[];
  uint32_t* xbuf = nullptr;
  if constexpr (G > 1) {
    __shared__ uint32_t xs[grp::buffer_words<G, XA>()];
    xbuf = xs;
  }
  for (int i = threadIdx.x; i < NTAB; i += blockDim.x) sm[i] = tab.v[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  Grp<G, CB> g = grp::make<G, XA, CB>(warp, 1, xbuf);
  const int lane = g.lane;
  int r;  // the read; a cluster's blocks hold one, so the test is the cluster's
  if constexpr (CB == 1)
    r = blockIdx.x * RB + warp / G;
  else
    r = blockIdx.x / CB;
  if (r >= nreads) return;  // only at G = 1 (RB = 1 otherwise)
  Stage<32 * C * G, K>& sg = reinterpret_cast<Stage<32 * C * G, K>*>(stage_raw)[warp / G];
  const float* tf = sm;
  const float* emf = sm + 25;
  const float* egf = sm + 61;
  const float gg = sm[91];
  const float mg = sm[92];
  const float thr = sm[93];
  const int w0 = g.gl * C;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  const int kend = m[r] + n[r];
  const int kq = min(kend + (kend & 1), k_pad);     // the read's last diagonal
  // the read's states and rescale inverses must fit its slot (kend below
  // m + n otherwise); a trap, not an assert, so no build flag removes it
  if (woff[r] + (int64_t)kq * NS * W + (kq + 1 + 3) / 4 * 4 > woff[r + 1]) __trap();
  float* fs = ws + woff[r];                         // row k-1: diagonal k
  float* sf = fs + (size_t)kq * NS * W;             // [k]: diagonal k

  // rows past the read's own diagonals: what the skipped diagonals give
  if constexpr (XP)
    fill_rows(out1 + (size_t)r * (k_pad + 1) * 4, kq, k_pad, 16, 0u, g.gl, 32 * G * CB);
  if constexpr (MEA)
    fill_rows((int8_t*)out2 + (size_t)r * (k_pad + 1) * W, kq, k_pad, W, 0x03030303u, g.gl,
              32 * G * CB);
  if constexpr (GAM)
    fill_rows(out3 + (size_t)r * (k_pad + 1) * W, kq, k_pad, W * 4, 0u, g.gl, 32 * G * CB);

  // ---------------- phase A: forward, diagonals 1..kq ----------------
  float acc = 0.f, fin_end = 1.f;
  forward_pass<C, G, false, K, CB>(tf, emf, egf, sg.cd, xy, k_pad, kq, kend, fs, sf, g, acc,
                                   fin_end);
  if (g.gl == 0) loglik[r] = acc;

  // ------- phase B: backward + the EM sums or the retire stream, kq..0 -------
  const float inv_fin = 1.f / fin_end;
  Bwd<C> bw;
  bwd_init<C>(bw);
  float g_next = 0.f;
  // EM sums of this lane's cells: 25 transitions | 16 match bins | delete
  // states 1, 3 by x (8) | insert states 2, 4 by y (8)
  float em[EM ? 57 : 1];
#pragma unroll
  for (int i = 0; i < (EM ? 57 : 1); ++i) em[i] = 0.f;
  // exp mode: expected counts of bases 0-3 at this lane's band columns
  float ex[XP ? 4 : 1][C];
#pragma unroll
  for (int i = 0; i < (XP ? 4 : 1); ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) ex[i][c] = 0.f;
  // the MEA scores of diagonals k+1 and k+2 and the posteriors it reads
  // of k+1 and k+2 (the decode modes, above W = 512: mea_kernel's phase 2)
  float u1[MEA ? C : 1], u2[MEA ? C : 1], gm1[MEA ? C : 1], gm2[MEA ? C : 1],
      gd1[MEA ? C : 1], gi1[MEA ? C : 1];
#pragma unroll
  for (int c = 0; c < (MEA ? C : 1); ++c) {
    u1[c] = NEG;
    u2[c] = NEG;
    gm1[c] = gm2[c] = gd1[c] = gi1[c] = 0.f;
  }

  // chunk q: slots s = 0..K-1 hold diagonal q*K + s (states, codes) and
  // sf[q*K + s + 1]; diagonal 0 has no stored row (the CB > 1 code as
  // in forward_pass)
  auto stage_bwd = [&](int q) {
    const int buf = q & 1;
    const int lo = max(1, q * K), hi = min(kq, q * K + K - 1);
    if (hi >= lo) {
      const int s0 = lo - q * K, rows = hi - lo + 1;
      if constexpr (CB == 1) {
        warp_copy(sg.st[buf][s0], fs + (size_t)(lo - 1) * NS * W, rows * NS * W * 4, g.gl,
                  32 * G);
        warp_copy(sg.cd[buf][s0], xy + (size_t)(lo - 1) * W, rows * W, g.gl, 32 * G);
      } else {  // the block's columns: a row of WB floats of each state
        constexpr int WB = 32 * C * G;
        const int rk = grp::rank(g);
        rows_copy<WB * 4>(sg.st[buf][s0], fs + (size_t)(lo - 1) * NS * W + rk * WB, rows * NS,
                          W * 4, g.gl - rk * 32 * G, 32 * G);
        rows_copy<WB>(sg.cd[buf][s0], xy + (size_t)(lo - 1) * W + rk * WB, rows, W,
                      g.gl - rk * 32 * G, 32 * G);
      }
    }
    if constexpr (CB == 1) {
      if (g.gl < K && q * K + g.gl + 1 <= kq)
        cp_async4(&sg.sf[buf][g.gl], sf + q * K + g.gl + 1);
    } else {  // by the block's threads
      const int t = g.gl - grp::rank(g) * 32 * G;
      if (t < K && q * K + t + 1 <= kq) cp_async4(&sg.sf[buf][t], sf + q * K + t + 1);
    }
    cp_commit();
  };
  // phase A's stores are read back by other lanes' copies (at CB > 1 rank
  // 0's rescale inverses by the other blocks too)
  if constexpr (CB == 1)
    __threadfence_block();
  else
    __threadfence();
  grp::sync(g);
  stage_bwd(kq / K);
#pragma unroll 1
  for (int q = kq / K; q >= 0; --q) {
    cp_wait_all();  // chunk q has landed
    grp::sync(g);    // and every lane is done with chunk q + 1's buffer
    if (q > 0) stage_bwd(q - 1);
    const int buf = q & 1;
    for (int k = min(kq, q * K + K - 1); k >= q * K; --k) {
      const int s = k - q * K;
      float fh[NS][C];  // forward states of diagonal k
      uint8_t ck[C];    // codes of diagonal k
      if (k >= 1) {
        if constexpr (CB == 1) {
          load_states<C, W>(sg.st[buf][s], w0, fh);
          load_codes<C>(sg.cd[buf][s], w0, ck);
        } else {  // the block's columns
          constexpr int WB = 32 * C * G;
          load_states<C, WB>(sg.st[buf][s], w0 - grp::rank(g) * WB, fh);
          load_codes<C>(sg.cd[buf][s], w0 - grp::rank(g) * WB, ck);
        }
      } else {
#pragma unroll
        for (int st = 0; st < NS; ++st)
#pragma unroll
          for (int c = 0; c < C; ++c) fh[st][c] = (w0 + c == 0) ? 1.0f / 5.0f : 0.f;
      }
      const float sf_next = (k & 1) ? sg.sf[buf][s] : 1.f;
      const bool is_end = k == kend;

      float dest[NS][C], nw[NS][C], safe, inv;
      bwd_step<C, G>(tf, bw, k, is_end, g, wl, dest, nw, safe, inv);
      const float factor_trans = g_next * sf_next;
      float g_k = is_end ? inv_fin : factor_trans * safe;
      g_k = fminf(g_k, 3e37f);

      float gam[NS][C];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int st = 0; st < NS; ++st) gam[st][c] = (fh[st][c] * nw[st][c]) * g_k;
      if constexpr (GAM)  // row k of the read's gamma_match band
        store_row<C>(out3 + ((size_t)r * (k_pad + 1) + k) * W, w0, gam[0]);

      if constexpr (MEA) {
        // mea_kernel's phase 2 step on the same floats: the MEA carry and
        // the direction word, ties diag before del before ins (written
        // out as there: a shared device function moved mea_kernel's
        // machine code)
        const int d2n2 = bw.d1n1 + bw.d1n2 - 1;
        float new_u[C], g_m[C], g_d[C], g_i[C];
        float v[3][C], td[C], tl[C], tu[C], hi[3], lo[3];  // v: diag, left, up
#pragma unroll
        for (int c = 0; c < C; ++c) {
          g_m[c] = gam[0][c];
          g_d[c] = gam[1][c] + gam[3][c];
          g_i[c] = gam[2][c] + gam[4][c];
          v[0][c] = (u2[c] + gm2[c]) - mg;
          v[1][c] = u1[c] + gg * gd1[c];
          v[2][c] = u1[c] + gg * gi1[c];
        }
        seam<C, G, 3>(g, v, NEG, hi, lo);
        shift<C>(v[0], td, -d2n2, hi[0], lo[0], lane);
        shift<C>(v[1], tl, 1 - bw.d1n1, hi[1], lo[1], lane);
        shift<C>(v[2], tu, -bw.d1n1, hi[2], lo[2], lane);
        uint32_t word = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float best = fmaxf(fmaxf(td[c], tl[c]), tu[c]);
          const int choice = best == td[c] ? 0 : (best == tl[c] ? 1 : 2);
          // a dead lane (at or above wl) stays unreachable, as outside
          new_u[c] = is_end ? ((w0 + c == 0) ? 0.f : NEG) : (w0 + c < wl ? best : NEG);
          const bool ok = new_u[c] > NEG / 2 && !is_end;
          word |= (uint32_t)(ok ? choice : 3) << (8 * c);
        }
        // row k of the read's direction codes: diagonal k
        store_codes<C>((int8_t*)out2 + ((size_t)r * (k_pad + 1) + k) * W, w0, word);
        if (k == 0) {
          if (g.gl == 0) out1[r] = new_u[0];  // the MEA score
          break;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          u2[c] = u1[c];
          u1[c] = new_u[c];
          gm2[c] = gm1[c];
          gm1[c] = g_m[c];
          gd1[c] = g_d[c];
          gi1[c] = g_i[c];
        }
      }

      if constexpr (XP) {
        // retire column wl - 1 on the k+1 -> k shift, move the band up by
        // d1[k+1] within the live columns, then bin diagonal k's
        // thresholded gamma_match
        const float d1f = (float)bw.d1n1;
        if (g.gl == (wl - 1) / C) {
          const int tc = (wl - 1) % C;  // the top column's cell in its lane
          float top[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            top[i] = ex[i][0];
#pragma unroll
            for (int c = 1; c < C; ++c) top[i] = c == tc ? ex[i][c] : top[i];
          }
          *reinterpret_cast<float4*>(out1 + ((size_t)r * (k_pad + 1) + k) * 4) =
              make_float4(top[0] * d1f, top[1] * d1f, top[2] * d1f, top[3] * d1f);
        }
        float hi[4], lo[4];
        seam<C, G, 4>(g, ex, 0.f, hi, lo);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sh[C];
          shift<C>(ex[i], sh, -1, hi[i], lo[i], lane);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float v = ex[i][c] + d1f * (sh[c] - ex[i][c]);
            ex[i][c] = w0 + c < wl ? v : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float g0 = gam[0][c];
          const float gmz = g0 * (g0 > thr ? 1.f : 0.f);
          const int y = k >= 1 ? (ck[c] & 7) : 5;  // diagonal 0: sentinels
#pragma unroll
          for (int i = 0; i < 4; ++i) ex[i][c] = ex[i][c] + gmz * (y == i ? 1.f : 0.f);
        }
      }

      if constexpr (EM) {
        // xi_k[s][t] without its tf factor.  dest is the value before the
        // end-cell overwrite, and g_next is 0 until the read's own end
        // diagonal has passed.
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int st = 0; st < NS; ++st) {
            const float fsc = fh[st][c] * factor_trans;
#pragma unroll
            for (int t = 0; t < NS; ++t) em[st * 5 + t] = em[st * 5 + t] + fsc * dest[t][c];
          }
        if (k == 0) break;  // diagonal 0 holds no base: nothing to bin
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int x = (ck[c] >> 3) & 7;
          const int y = ck[c] & 7;
          const int xb = x < 4 ? x : -1;
          const int yb = y < 4 ? y : -1;
          bin_add<16>(em + 25, (xb >= 0 && yb >= 0) ? x * 4 + y : -1, gam[0][c]);
          bin_add<4>(em + 41, xb, gam[1][c]);
          bin_add<4>(em + 45, xb, gam[3][c]);
          bin_add<4>(em + 49, yb, gam[2][c]);
          bin_add<4>(em + 53, yb, gam[4][c]);
        }
      } else if (k == 0) {
        break;
      }

      // carry down to diagonal k - 1
      bwd_carry<C>(bw, nw, inv, emf, egf, ck, sg.cd[buf][s][0]);
      g_next = g_k;
    }
  }

  if constexpr (XP) {  // the flush: the columns left after diagonal 0
    float* fl = (float*)out2 + (size_t)r * 4 * W;
#pragma unroll
    for (int i = 0; i < 4; ++i) store_row<C>(fl + i * W, w0, ex[i]);
  }
  if constexpr (EM) {
    // sum over the band's 32 G lanes (the plain version's order,
    // ops/realign.py::_lane_total): at G > 1 the warps first fold onto
    // warp 0, of the nw still holding sums warps h = ceil(nw / 2) .. nw - 1
    // onto warps 0 .. nw - h - 1, lane for lane, through the staging
    // buffer (free once every warp is past the last chunk): at G = 2 and
    // 4 the xor butterfly's steps across warps (lane l plus lane l + 32 h),
    // at G = 3 warp 2 onto warp 0, then warp 1; then one warp's five
    // butterfly steps; then lay the counts out as trans [from][to] and
    // emis [state][x * 4 + y], each gap count spread over the base its
    // state does not read
    if constexpr (G > 1) {
      float* red = reinterpret_cast<float*>(&sg);  // [warp - h][count][lane]
      static_assert(G / 2 * 57 * 32 * 4 <= (int)sizeof(Stage<32 * C * G, K>),
                    "the sums fit the stage");
      if constexpr (CB > 1) {
        // the upper half of the blocks still holding sums onto the lower,
        // warp for warp and lane for lane (the fold's steps over the
        // cluster's CB G warps while more than G hold sums): each upper
        // block's warps write their sums into its own stage, and the
        // lower block's read them there
        static_assert((CB & (CB - 1)) == 0, "a power of two of blocks");
        static_assert(G * 57 * 32 * 4 <= (int)sizeof(Stage<32 * C * G, K>),
                      "the sums fit the stage");
        const int rk = grp::rank(g), wb = g.wg - rk * G;
#pragma unroll 1
        for (int nb = CB; nb > 1; nb /= 2) {
          const int hb = nb / 2;
          grp::sync(g);  // the buffer is free
          if (rk >= hb && rk < nb) {
#pragma unroll
            for (int i = 0; i < 57; ++i) red[(wb * 57 + i) * 32 + lane] = em[i];
          }
          grp::sync(g);
          if (rk < nb - hb) {
#pragma unroll
            for (int i = 0; i < 57; ++i)
              em[i] = em[i] + grp::remote_load(red + (wb * 57 + i) * 32 + lane, rk + hb);
          }
        }
      }
#pragma unroll 1
      for (int nw = G; nw > 1; nw = (nw + 1) / 2) {
        const int h = (nw + 1) / 2;
        grp::sync(g);  // the buffer is free
        if (g.wg >= h && g.wg < nw) {
#pragma unroll
          for (int i = 0; i < 57; ++i) red[((g.wg - h) * 57 + i) * 32 + lane] = em[i];
        }
        grp::sync(g);
        if (g.wg < nw - h) {
#pragma unroll
          for (int i = 0; i < 57; ++i) em[i] = em[i] + red[(g.wg * 57 + i) * 32 + lane];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 57; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        em[i] = em[i] + __shfl_xor_sync(FULL, em[i], off);
    if (g.gl == 0) {
      float* tr = out1 + (size_t)r * 25;
      float* es = (float*)out2 + (size_t)r * 80;
#pragma unroll
      for (int i = 0; i < 25; ++i) tr[i] = tf[i] * em[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) es[i] = em[25 + i];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          es[16 + a * 4 + q] = em[41 + a] / 4.0f;  // state 1: by x
          es[48 + a * 4 + q] = em[45 + a] / 4.0f;  // state 3: by x
          es[32 + q * 4 + a] = em[49 + a] / 4.0f;  // state 2: by y
          es[64 + q * 4 + a] = em[53 + a] / 4.0f;  // state 4: by y
        }
    }
  }
  // no block leaves while another can still read its shared memory
  if constexpr (CB > 1) grp::cluster_sync();
}

// floats of mea_kernel's workspace slot of a read of kq diagonals in
// segments of ms: the forward's states and sf, safe, then the
// checkpoints (b1 and b2m, 6 x W f32 each)
__device__ __forceinline__ int64_t mea_slot_floats(int kq, int W, int ms) {
  const int64_t kp4 = (kq + 1 + 3) / 4 * 4;
  return (int64_t)kq * NS * W + 2 * kp4 + (int64_t)(kq / ms + 1) * (NS + 1) * W;
}

// Outputs: `score` (B,) f32 (the MEA score), `dirs` (B, k_pad + 1, W)
// int8 direction codes and, in DECODE_GAMMA, `gband` (B, k_pad + 1, W)
// f32.  `ws`, `woff` as realign_kernel's, one read a block of MEA_WARPS
// groups of G warps (role = warp / G); dynamic shared memory holds one
// MeaStage<W, mea_segment(G)>.
template <int C, int G, int MODE>
__global__ void __launch_bounds__(MEA_WARPS * 32 * G, mea_blocks(C, G))
mea_kernel(Tables tab, const uint8_t* __restrict__ xyc, const int32_t* __restrict__ m,
           const int32_t* __restrict__ n, int k_pad, int wl, float* __restrict__ ws,
           const int64_t* __restrict__ woff, float* __restrict__ loglik,
           float* __restrict__ score, int8_t* __restrict__ dirs,
           float* __restrict__ gband) {
  constexpr int W = 32 * C * G;
  constexpr int MS = mea_segment(G);  // segment: phase 2's chunk
  constexpr bool GAM = MODE == DECODE_GAMMA;
  __shared__ float sm[NTAB];
  extern __shared__ __align__(16) unsigned char stage_raw[];
  MeaStage<W, MS>& sg = *reinterpret_cast<MeaStage<W, MS>*>(stage_raw);
  const int warp = threadIdx.x >> 5;
  const int role = warp / G;
  uint32_t* xbuf = nullptr;
  if constexpr (G > 1) {
    __shared__ uint32_t xs[MEA_WARPS][grp::buffer_words<G, XA>()];
    xbuf = xs[role];
  }
  for (int i = threadIdx.x; i < NTAB; i += blockDim.x) sm[i] = tab.v[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSLOT; ++i) {  // one arrival a lane of a group
      mbar_init(&sg.full[i], 32 * G);
      mbar_init(&sg.empty[i], 32 * G);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Grp<G> g = grp::make<G, XA>(warp, role + 1, xbuf);
  const int r = blockIdx.x;
  const float* tf = sm;
  const float* emf = sm + 25;
  const float* egf = sm + 61;
  const float gg = sm[91];
  const float mg = sm[92];
  const int lane = g.lane;
  const int w0 = g.gl * C;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  const int kend = m[r] + n[r];
  const int kq = min(kend + (kend & 1), k_pad);     // the read's last diagonal
  const int nseg = kq / MS + 1;                     // segments of diagonals 0..kq
  // the read's slot must hold it (kend below m + n otherwise): a trap
  if (woff[r] + mea_slot_floats(kq, W, MS) > woff[r + 1]) __trap();
  const int kp4 = (kq + 1 + 3) / 4 * 4;
  float* fs = ws + woff[r];               // row k-1: diagonal k
  float* sf = fs + (size_t)kq * NS * W;   // [k]: diagonal k (even k)
  float* sa = sf + kp4;                   // [k]: the backward's safe at k
  float* ckp = sa + kp4;                  // checkpoint j: b1, then b2m

  // ---- phase 1: forward (role 0) beside backward (role 1) ----
  float fin_end = 1.f;
  if (role == 0) {
    float acc = 0.f;
    forward_pass<C, G>(tf, emf, egf, sg.u.p1.fcd, xy, k_pad, kq, kend, fs, sf, g, acc,
                       fin_end);
    if (g.gl == 0) loglik[r] = acc;
  } else if (role == 1) {
    Bwd<C> bw;
    bwd_init<C>(bw);
    auto stage = [&](int q) {  // codes of chunk q's diagonals in 1..kq
      const int lo = max(1, q * CH), hi = min(kq, q * CH + CH - 1);
      if (hi >= lo)
        warp_copy(sg.u.p1.bcd[q & 1][lo - q * CH], xy + (size_t)(lo - 1) * W,
                  (hi - lo + 1) * W, g.gl, 32 * G);
      cp_commit();
    };
    stage(kq / CH);
#pragma unroll 1
    for (int q = kq / CH; q >= 0; --q) {
      cp_wait_all();  // chunk q has landed
      grp::sync(g);    // and every lane is done with chunk q + 1's buffer
      if (q > 0) stage(q - 1);
      const int buf = q & 1;
      for (int k = min(kq, q * CH + CH - 1); k >= q * CH; --k) {
        const int s = k - q * CH;
        // the top of segment k / MS: its checkpoint (at MS = CH the
        // chunk's last diagonal)
        if (k == kq || (MS == CH ? s == MS - 1 : k % MS == MS - 1)) {
          float* cp = ckp + (size_t)(k / MS) * (NS + 1) * W;
          store_states<C, W>(cp, w0, bw.b1);
          store_row<C>(cp + NS * W, w0, bw.b2m);
        }
        float dest[NS][C], nw[NS][C], safe, inv;
        bwd_step<C, G>(tf, bw, k, k == kend, g, wl, dest, nw, safe, inv);
        if (g.gl == 0) sa[k] = safe;
        if (k == 0) break;
        uint8_t ck[C];
        load_codes<C>(sg.u.p1.bcd[buf][s], w0, ck);
        bwd_carry<C>(bw, nw, inv, emf, egf, ck, sg.u.p1.bcd[buf][s][0]);
      }
    }
  } else {  // the rows past the read's own diagonals
    fill_rows(dirs + (size_t)r * (k_pad + 1) * W, kq, k_pad, W, 0x03030303u, g.gl, 32 * G);
    if constexpr (GAM)
      fill_rows(gband + (size_t)r * (k_pad + 1) * W, kq, k_pad, W * 4, 0u, g.gl, 32 * G);
  }
  __syncthreads();  // the workspace is written; phase 1's buffers are free

  // ---- phase 2: the posterior + MEA pass (role 0), fed by roles 1, 2 ----
  if (role == 0) {
    const float inv_fin = 1.f / fin_end;
    float u1[C], u2[C], gm1[C], gm2[C], gd1[C], gi1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      u1[c] = NEG;
      u2[c] = NEG;
      gm1[c] = gm2[c] = gd1[c] = gi1[c] = 0.f;
    }
    float g_next = 0.f;
    int d1n1 = 0, d1n2 = 0;  // band deltas of diagonals k+1, k+2
    auto stage = [&](int q) {
      const int buf = q & 1;
      const int lo = max(1, q * MS), hi = min(kq, q * MS + MS - 1);
      if (hi >= lo) {
        const int s0 = lo - q * MS, rows = hi - lo + 1;
        warp_copy(sg.u.p2.st[buf][s0], fs + (size_t)(lo - 1) * NS * W, rows * NS * W * 4,
                  g.gl, 32 * G);
        warp_copy(sg.u.p2.cd[buf][s0], xy + (size_t)(lo - 1) * W, rows * W, g.gl, 32 * G);
      }
      if (g.gl < MS && q * MS + g.gl + 1 <= kq)
        cp_async4(&sg.u.p2.sf[buf][g.gl], sf + q * MS + g.gl + 1);
      if (g.gl < MS && q * MS + g.gl <= kq)
        cp_async4(&sg.u.p2.sa[buf][g.gl], sa + q * MS + g.gl);
      cp_commit();
    };
    stage(nseg - 1);
#pragma unroll 1
    for (int q = nseg - 1; q >= 0; --q) {
      cp_wait_all();  // chunk q has landed
      grp::sync(g);    // and every lane is done with chunk q + 1's buffer
      if (q > 0) stage(q - 1);
      const int buf = q & 1;
      const int t = nseg - 1 - q, slot = t % NSLOT;
      mbar_wait(&sg.full[slot], (t / NSLOT) & 1);  // segment q's backward states
      for (int k = min(kq, q * MS + MS - 1); k >= q * MS; --k) {
        const int s = k - q * MS;
        float fh[NS][C];  // forward states of diagonal k
        if (k >= 1) {
          load_states<C, W>(sg.u.p2.st[buf][s], w0, fh);
        } else {
#pragma unroll
          for (int st = 0; st < NS; ++st)
#pragma unroll
            for (int c = 0; c < C; ++c) fh[st][c] = (w0 + c == 0) ? 1.0f / 5.0f : 0.f;
        }
        float nw[NS][C];  // backward states of diagonal k
        load_states<C, W>(sg.u.p2.ring[slot][s], w0, nw);
        const float sf_next = (k & 1) ? sg.u.p2.sf[buf][s] : 1.f;
        const float safe = sg.u.p2.sa[buf][s];
        const bool is_end = k == kend;
        const int d2n2 = d1n1 + d1n2 - 1;
        const float factor_trans = g_next * sf_next;
        float g_k = is_end ? inv_fin : factor_trans * safe;
        g_k = fminf(g_k, 3e37f);

        float gam[NS][C];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int st = 0; st < NS; ++st) gam[st][c] = (fh[st][c] * nw[st][c]) * g_k;
        if constexpr (GAM)  // row k of the read's gamma_match band
          store_row<C>(gband + ((size_t)r * (k_pad + 1) + k) * W, w0, gam[0]);
        float new_u[C], g_m[C], g_d[C], g_i[C];
        float v[3][C], td[C], tl[C], tu[C], hi[3], lo[3];  // v: diag, left, up
#pragma unroll
        for (int c = 0; c < C; ++c) {
          g_m[c] = gam[0][c];
          g_d[c] = gam[1][c] + gam[3][c];
          g_i[c] = gam[2][c] + gam[4][c];
          v[0][c] = (u2[c] + gm2[c]) - mg;
          v[1][c] = u1[c] + gg * gd1[c];
          v[2][c] = u1[c] + gg * gi1[c];
        }
        seam<C, G, 3>(g, v, NEG, hi, lo);
        shift<C>(v[0], td, -d2n2, hi[0], lo[0], lane);
        shift<C>(v[1], tl, 1 - d1n1, hi[1], lo[1], lane);
        shift<C>(v[2], tu, -d1n1, hi[2], lo[2], lane);
        uint32_t word = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float best = fmaxf(fmaxf(td[c], tl[c]), tu[c]);
          const int choice = best == td[c] ? 0 : (best == tl[c] ? 1 : 2);
          // a dead lane (at or above wl) stays unreachable, as outside
          new_u[c] = is_end ? ((w0 + c == 0) ? 0.f : NEG) : (w0 + c < wl ? best : NEG);
          const bool ok = new_u[c] > NEG / 2 && !is_end;
          word |= (uint32_t)(ok ? choice : 3) << (8 * c);
        }
        // row k of the read's direction codes: diagonal k
        store_codes<C>(dirs + ((size_t)r * (k_pad + 1) + k) * W, w0, word);
        if (k == 0) {
          if (g.gl == 0) score[r] = new_u[0];  // the MEA score
          break;
        }
        // carry down to diagonal k - 1
#pragma unroll
        for (int c = 0; c < C; ++c) {
          u2[c] = u1[c];
          u1[c] = new_u[c];
          gm2[c] = gm1[c];
          gm1[c] = g_m[c];
          gd1[c] = g_d[c];
          gi1[c] = g_i[c];
        }
        g_next = g_k;
        d1n2 = d1n1;
        d1n1 = (sg.u.p2.cd[buf][s][0] >> 6) & 1;
      }
      mbar_arrive(&sg.empty[slot]);
    }
  } else {
    // producer p recomputes segments nseg - 1 - p, nseg - 3 - p, ...
    const int p = role - 1;
    uint8_t(*pc)[MS + 2][W] = sg.u.p2.pcd[p];
    auto stage = [&](int j, int buf) {  // codes of diagonals jMS .. jMS + MS + 1 in 1..kq
      const int lo = max(1, j * MS), hi = min(kq, j * MS + MS + 1);
      if (hi >= lo)
        warp_copy(pc[buf][lo - j * MS], xy + (size_t)(lo - 1) * W, (hi - lo + 1) * W, g.gl,
                  32 * G);
      cp_commit();
    };
    float c1[NS][C], c2m[C], csafe = 1.f;  // the next segment's checkpoint
    auto load_ck = [&](int j) {
      const float* cp = ckp + (size_t)j * (NS + 1) * W;
      load_states<C, W>(cp, w0, c1);
      load_row<C>(cp + NS * W, w0, c2m);
      const int above = min(kq, j * MS + MS - 1) + 1;  // the diagonal above the segment
      csafe = above <= kq ? sa[above] : 1.f;
    };
    if (p < nseg) {
      stage(nseg - 1 - p, 0);
      load_ck(nseg - 1 - p);
    }
#pragma unroll 1
    for (int t = p, i = 0; t < nseg; t += 2, ++i) {
      const int j = nseg - 1 - t;
      const int lo = j * MS, hi = min(kq, lo + MS - 1);
      const int buf = i & 1, slot = t % NSLOT, use = t / NSLOT;
      Bwd<C> bw;
      bwd_init<C>(bw);
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int st = 0; st < NS; ++st) bw.b1[st][c] = c1[st][c];
        bw.b2m[c] = c2m[c];
      }
      bw.binv = recip(csafe);  // the rescale inverse of diagonal hi + 1, as computed there
      cp_wait_all();  // this segment's codes have landed
      grp::sync(g);    // and every lane is done with the other buffer
      if (t + 2 < nseg) {
        stage(j - 2, buf ^ 1);
        load_ck(j - 2);
      }
      // the emissions and deltas of diagonals hi + 2, then hi + 1
#pragma unroll
      for (int d = 2; d >= 1; --d) {
        if (hi + d <= kq) {
          uint8_t ck[C];
          load_codes<C>(pc[buf][hi + d - lo], w0, ck);
          bwd_codes<C>(bw, emf, egf, ck, pc[buf][hi + d - lo][0]);
        }
      }
      if (use > 0) mbar_wait(&sg.empty[slot], (use - 1) & 1);  // the slot is free
      for (int k = hi; k >= lo; --k) {
        float dest[NS][C], nw[NS][C], safe, inv;
        bwd_step<C, G>(tf, bw, k, k == kend, g, wl, dest, nw, safe, inv);
        store_states<C, W>(sg.u.p2.ring[slot][k - lo], w0, nw);
        if (k == lo) break;
        uint8_t ck[C];
        load_codes<C>(pc[buf][k - lo], w0, ck);
        bwd_carry<C>(bw, nw, inv, emf, egf, ck, pc[buf][k - lo][0]);
      }
      mbar_arrive(&sg.full[slot]);
    }
  }
}

// floats of gamma_kernel's workspace slot of a read of kq diagonals: the
// backward's match rows of diagonals 0..kq, the forward's sf, then safe
// (which the g chain overwrites with g)
__device__ __forceinline__ int64_t gamma_slot_floats(int kq, int W) {
  const int64_t kp4 = (kq + 1 + 3) / 4 * 4;
  return (int64_t)(kq + 1) * W + 2 * kp4;
}

// Outputs: `loglik` (B,) and `gband` (B, k_pad + 1, W) f32, the
// gamma_match band.  `ws`, `woff` as realign_kernel's, one read a block
// of gamma_roles(G) groups of G warps (role = warp / G).  `sm` holds the
// model tables, which the entry point (gamma_kernel, or gamma_kernel_c4
// at W >= 128) has copied in.
template <int C, int G>
__device__ __forceinline__ void gamma_read(const float* sm, const uint8_t* __restrict__ xyc,
                                           const int32_t* __restrict__ m,
                                           const int32_t* __restrict__ n, int k_pad, int wl,
                                           float* __restrict__ ws,
                                           const int64_t* __restrict__ woff,
                                           float* __restrict__ loglik,
                                           float* __restrict__ gband) {
  constexpr int W = 32 * C * G;
  __shared__ GammaStage<W> sg;
  const int warp = threadIdx.x >> 5;
  const int role = warp / G;
  uint32_t* xbuf = nullptr;
  if constexpr (G > 1) {
    __shared__ uint32_t xs[2][grp::buffer_words<G, XA>()];  // the forward's and the backward's
    xbuf = xs[role & 1];
  }
  __syncthreads();
  Grp<G> g = grp::make<G, XA>(warp, role + 1, xbuf);
  const int lane = g.lane;
  const int r = blockIdx.x;
  const float* tf = sm;
  const float* emf = sm + 25;
  const float* egf = sm + 61;
  const int w0 = g.gl * C;
  const uint8_t* xy = xyc + (size_t)r * k_pad * W;  // row k-1: diagonal k
  const int kend = m[r] + n[r];
  const int kq = min(kend + (kend & 1), k_pad);     // the read's last diagonal
  // the read's slot must hold it (kend below m + n otherwise): a trap
  if (woff[r] + gamma_slot_floats(kq, W) > woff[r + 1]) __trap();
  const int kp4 = (kq + 1 + 3) / 4 * 4;
  float* band = gband + (size_t)r * (k_pad + 1) * W;  // row k: diagonal k
  float* bws = ws + woff[r];                // row k: the backward's match state
  float* sf = bws + (size_t)(kq + 1) * W;   // [k]: diagonal k (even k)
  float* sa = sf + kp4;                     // [k]: safe at k, then g_k

  // ---- phase 1: forward (role 0) beside backward (role 1) ----
  float fin_end = 1.f;
  if (role == 0) {
    float f0[C];  // diagonal 0's match state
#pragma unroll
    for (int c = 0; c < C; ++c) f0[c] = (w0 + c == 0) ? 1.0f / 5.0f : 0.f;
    store_row<C>(band, w0, f0);
    float acc = 0.f;
    forward_pass<C, G, true>(tf, emf, egf, sg.fcd, xy, k_pad, kq, kend, band, sf, g, acc,
                             fin_end);
    if (g.gl == 0) loglik[r] = acc;
  } else if (role == 1) {
    Bwd<C> bw;
    bwd_init<C>(bw);
    auto stage = [&](int q) {  // codes of chunk q's diagonals in 1..kq
      const int lo = max(1, q * CH), hi = min(kq, q * CH + CH - 1);
      if (hi >= lo)
        warp_copy(sg.bcd[q & 1][lo - q * CH], xy + (size_t)(lo - 1) * W, (hi - lo + 1) * W,
                  g.gl, 32 * G);
      cp_commit();
    };
    stage(kq / CH);
#pragma unroll 1
    for (int q = kq / CH; q >= 0; --q) {
      cp_wait_all();  // chunk q has landed
      grp::sync(g);    // and every lane is done with chunk q + 1's buffer
      if (q > 0) stage(q - 1);
      const int buf = q & 1;
      for (int k = min(kq, q * CH + CH - 1); k >= q * CH; --k) {
        const int s = k - q * CH;
        float dest[NS][C], nw[NS][C], safe, inv;
        bwd_step<C, G>(tf, bw, k, k == kend, g, wl, dest, nw, safe, inv);
        store_row<C>(bws + (size_t)k * W, w0, nw[0]);
        if (g.gl == 0) sa[k] = safe;
        if (k == 0) break;
        uint8_t ck[C];
        load_codes<C>(sg.bcd[buf][s], w0, ck);
        bwd_carry<C>(bw, nw, inv, emf, egf, ck, sg.bcd[buf][s][0]);
      }
    }
  } else {  // the rows past the read's own diagonals
    fill_rows(band, kq, k_pad, W * 4, 0u, threadIdx.x - 64 * G,
              (gamma_roles(G) - 2) * 32 * G);
  }
  __syncthreads();  // both chains' rows and scales are written

  // ---- the g chain, kq..0, one serial scalar recursion (warp 0) ----
  // g_k = min(is_end ? 1 / fin : (g_{k+1} sf_{k+1}) safe_k, 3e37), with
  // sf_{k+1} = 1 for even k and g 0 until the end diagonal has passed.
  // Lane j holds the scales of diagonal top - j of each 32; every lane
  // runs the chain and lane j keeps g of its diagonal.
  if (warp == 0) {
    const float inv_fin = 1.f / fin_end;
    auto fetch = [&](int top, float& sfn, float& saf) {
      const int k = top - lane;
      sfn = 1.f;
      saf = 1.f;
      if (k >= 0) {
        if (k & 1) sfn = sf[k + 1];
        saf = sa[k];
      }
    };
    float sfn, saf;
    fetch(kq, sfn, saf);
    float g_next = 0.f;
#pragma unroll 1
    for (int top = kq; top >= 0; top -= 32) {
      float sfn2, saf2;  // the next 32, in flight beside this chain
      fetch(top - 32, sfn2, saf2);
      float mine = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // diagonals below 0 give unused g
        const float a = __shfl_sync(FULL, sfn, j);
        const float b = __shfl_sync(FULL, saf, j);
        float gv = top - j == kend ? inv_fin : (g_next * a) * b;
        gv = fminf(gv, 3e37f);
        if (lane == j) mine = gv;
        g_next = gv;
      }
      if (top - lane >= 0) sa[top - lane] = mine;
      sfn = sfn2;
      saf = saf2;
    }
  }
  __syncthreads();  // g is written

  // ---- phase 2: gamma = (f * b) * g over the read's rows, every warp ----
  {
    constexpr int V = W / 4;  // float4 a row
    float4* fb = reinterpret_cast<float4*>(band);
    const float4* bb = reinterpret_cast<const float4*>(bws);
    const int n4 = (kq + 1) * V;
    constexpr int NT = gamma_roles(G) * 32 * G, U = 4;
#pragma unroll 1
    for (int i0 = threadIdx.x; i0 < n4; i0 += NT * U) {
      float4 f[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT;
        if (i < n4) {
          f[u] = fb[i];
          b[u] = bb[i];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT;
        if (i < n4) {
          const float gv = sa[i / V];
          float4 o;
          o.x = (f[u].x * b[u].x) * gv;
          o.y = (f[u].y * b[u].y) * gv;
          o.z = (f[u].z * b[u].z) * gv;
          o.w = (f[u].w * b[u].w) * gv;
          fb[i] = o;
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(GAMMA_WARPS * 32)
gamma_kernel(Tables tab, const uint8_t* __restrict__ xyc, const int32_t* __restrict__ m,
             const int32_t* __restrict__ n, int k_pad, int wl, float* __restrict__ ws,
             const int64_t* __restrict__ woff, float* __restrict__ loglik,
             float* __restrict__ gband) {
  __shared__ float sm[NTAB];
  for (int i = threadIdx.x; i < NTAB; i += blockDim.x) sm[i] = tab.v[i];
  gamma_read<C, 1>(sm, xyc, m, n, k_pad, wl, ws, woff, loglik, gband);
}

// C = 4 (W = 128 G): under gamma_kernel's bound ptxas held W = 128 to
// 128 registers and spilled; at 2 blocks an SM (1 above W = 128) it
// takes what it needs, up to 168 registers in the 12 warps of G = 3 and 4
template <int G>
__global__ void __launch_bounds__(gamma_roles(G) * 32 * G, G == 1 ? 2 : 1)
gamma_kernel_c4(Tables tab, const uint8_t* __restrict__ xyc, const int32_t* __restrict__ m,
                const int32_t* __restrict__ n, int k_pad, int wl, float* __restrict__ ws,
                const int64_t* __restrict__ woff, float* __restrict__ loglik,
                float* __restrict__ gband) {
  __shared__ float sm[NTAB];
  for (int i = threadIdx.x; i < NTAB; i += blockDim.x) sm[i] = tab.v[i];
  gamma_read<4, G>(sm, xyc, m, n, k_pad, wl, ws, woff, loglik, gband);
}

// gamma_kernel at W = 32 and 64, gamma_kernel_c4 from W = 128
template <int C, int G>
auto gamma_entry() {
  if constexpr (C == 4)
    return gamma_kernel_c4<G>;
  else
    return gamma_kernel<C>;
}

// realign_kernel's cluster launch at CB > 1 (a read a cluster of CB
// blocks, nreads x CB blocks): its dynamic shared memory opted into,
// the grid, the block and the cluster's dimension in `cfg`
template <int C, int G, int MODE, int CB>
cudaError_t cluster_config(int nreads, cudaStream_t s, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  constexpr int smem = (int)sizeof(Stage<32 * C * G, realign_chunk(G)>);
  cudaError_t e = cudaFuncSetAttribute(realign_kernel<C, G, MODE, CB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(realign_kernel<C, G, MODE, CB>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(nreads * CB);
  cfg.blockDim = dim3(realign_warps(G) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CB;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return e;
}

template <int C, int G, int MODE, int CB = 1>
int launch_mode(const Tables& t, int nreads, cudaStream_t s, const void* xyc, const void* m,
                const void* n, int k_pad, int wl, void* ws, const void* woff, void* loglik,
                void* out1, void* out2, void* out3) {
  constexpr int W = 32 * C * G;
  if constexpr (CB > 1) {  // a read a cluster of CB blocks
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = cluster_config<C, G, MODE, CB>(nreads, s, cfg, attr);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, realign_kernel<C, G, MODE, CB>, t, (const uint8_t*)xyc,
                             (const int32_t*)m, (const int32_t*)n, nreads, k_pad, wl,
                             (float*)ws, (const int64_t*)woff, (float*)loglik, (float*)out1,
                             out2, (float*)out3);
    if (e != cudaSuccess) return (int)e;
  } else if constexpr ((MODE == DECODE || MODE == DECODE_GAMMA) && !two_phase(G)) {
    constexpr int smem = (int)sizeof(MeaStage<W, mea_segment(G)>);
    cudaError_t e = cudaFuncSetAttribute(mea_kernel<C, G, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mea_kernel<C, G, MODE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    mea_kernel<C, G, MODE><<<nreads, MEA_WARPS * 32 * G, smem, s>>>(
        t, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n, k_pad, wl, (float*)ws,
        (const int64_t*)woff, (float*)loglik, (float*)out1, (int8_t*)out2, (float*)out3);
  } else if constexpr (MODE == GAMMA && !two_phase(G)) {
    const auto kernel = gamma_entry<C, G>();
    kernel<<<nreads, gamma_roles(G) * 32 * G, 0, s>>>(
        t, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n, k_pad, wl, (float*)ws,
        (const int64_t*)woff, (float*)loglik, (float*)out3);
  } else {
    constexpr int RB = realign_warps(G) / G;  // reads a block
    constexpr int smem = RB * (int)sizeof(Stage<W, realign_chunk(G)>);
    if constexpr (smem > 48 * 1024) {  // W >= 128: above the default's 48 KB
      cudaError_t e = cudaFuncSetAttribute(realign_kernel<C, G, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(realign_kernel<C, G, MODE>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
    }
    realign_kernel<C, G, MODE>
        <<<(nreads + RB - 1) / RB, realign_warps(G) * 32, smem, s>>>(
            t, (const uint8_t*)xyc, (const int32_t*)m, (const int32_t*)n, nreads, k_pad, wl,
            (float*)ws, (const int64_t*)woff, (float*)loglik, (float*)out1, out2,
            (float*)out3);
  }
  return (int)cudaGetLastError();
}

// registers, local bytes, static and dynamic shared memory, threads and
// reads of a block, blocks a cluster and the clusters that can be
// resident at once (cudaOccupancyMaxActiveClusters; -1 without a
// cluster)
template <int C, int G, int MODE, int CB = 1>
int attrs_mode(int* out) {
  constexpr int W = 32 * C * G;
  constexpr bool MEA = (MODE == DECODE || MODE == DECODE_GAMMA) && !two_phase(G);
  cudaFuncAttributes a;
  cudaError_t e;
  out[6] = CB;
  out[7] = -1;
  if constexpr (CB > 1) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    e = cluster_config<C, G, MODE, CB>(1, nullptr, cfg, attr);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, realign_kernel<C, G, MODE, CB>);
    int clusters = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&clusters, realign_kernel<C, G, MODE, CB>, &cfg);
    out[3] = (int)cfg.dynamicSmemBytes;
    out[4] = realign_warps(G) * 32;
    out[5] = 1;
    out[7] = clusters;
  } else if constexpr (MEA) {
    e = cudaFuncGetAttributes(&a, mea_kernel<C, G, MODE>);
    out[3] = (int)sizeof(MeaStage<W, mea_segment(G)>);
    out[4] = MEA_WARPS * 32 * G;
    out[5] = 1;
  } else if constexpr (MODE == GAMMA && !two_phase(G)) {
    e = cudaFuncGetAttributes(&a, gamma_entry<C, G>());
    out[3] = 0;
    out[4] = gamma_roles(G) * 32 * G;
    out[5] = 1;
  } else {
    e = cudaFuncGetAttributes(&a, realign_kernel<C, G, MODE>);
    out[3] = (int)(realign_warps(G) / G * sizeof(Stage<W, realign_chunk(G)>));
    out[4] = realign_warps(G) * 32;
    out[5] = realign_warps(G) / G;
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)e;
}

template <int C, int G, int CB = 1>
int attrs_width(int mode, int* out) {
  switch (mode) {
    case DECODE:
      return attrs_mode<C, G, DECODE, CB>(out);
    case EM_MODE:
      return attrs_mode<C, G, EM_MODE, CB>(out);
    case GAMMA:
      return attrs_mode<C, G, GAMMA, CB>(out);
    case DECODE_GAMMA:
      return attrs_mode<C, G, DECODE_GAMMA, CB>(out);
    case EXP:
      return attrs_mode<C, G, EXP, CB>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int C, int G, int CB = 1>
int launch_width(int mode, const Tables& t, int nreads, cudaStream_t s, const void* xyc,
                 const void* m, const void* n, int k_pad, int wl, void* ws, const void* woff,
                 void* loglik, void* out1, void* out2, void* out3) {
#define NP_MODE(M)                                                                              \
  case M:                                                                                       \
    return launch_mode<C, G, M, CB>(t, nreads, s, xyc, m, n, k_pad, wl, ws, woff, loglik, out1, \
                                    out2, out3);
  switch (mode) {
    NP_MODE(DECODE)
    NP_MODE(EM_MODE)
    NP_MODE(GAMMA)
    NP_MODE(DECODE_GAMMA)
    NP_MODE(EXP)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NP_MODE
}

}  // namespace

extern "C" const char* np_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Registers, local memory (spill) bytes per thread, static and dynamic
// shared memory bytes per block, threads per block, reads per block,
// blocks per cluster (a read's at W = 1536 and 2048: 2) and the clusters
// that can be resident at once (-1 at W <= 1024, which launch no
// cluster; 0: the cluster cannot launch) of `mode` at band width W, into
// out[8].
extern "C" int np_realign_attrs(int mode, int W, int* out) {
  if (W == 2048) return attrs_width<4, 8, 2>(mode, out);
  if (W == 1536) return attrs_width<4, 6, 2>(mode, out);
  if (W == 1024) return attrs_width<4, 8>(mode, out);
  if (W == 768) return attrs_width<4, 6>(mode, out);
  if (W == 512) return attrs_width<4, 4>(mode, out);
  if (W == 384) return attrs_width<4, 3>(mode, out);
  if (W == 256) return attrs_width<4, 2>(mode, out);
  if (W == 128) return attrs_width<4, 1>(mode, out);
  if (W == 64) return attrs_width<2, 1>(mode, out);
  if (W == 32) return attrs_width<1, 1>(mode, out);
  return (int)cudaErrorInvalidValue;
}

// Launch `mode` (DECODE 0, EM 1, GAMMA 2, DECODE_GAMMA 3, EXP 4) on
// `stream`; returns cudaGetLastError() (0 on success).  W is 32, 64, 128,
// 256, 384, 512, 768, 1024, 1536 or 2048 (the last two a read a cluster
// of two blocks) and `wl` the live band width, 1 <= wl <= W.  `tables` is host
// memory: 91 model floats, then gap gamma, match gamma and the exp
// threshold (each mode reads what it uses).  `ws` is the workspace and
// `woff` (nreads + 1,) int64 each read's offset in it and, last, the end
// of the last read's slot, in floats, the offsets 16-byte aligned; with
// kq = m + n rounded up to even (at most k_pad) and kp4 = kq + 1 rounded
// up to a multiple of 4, read r needs kq * 5 * W floats of states and kp4
// rescale inverses, and in the decode modes kp4 more (the backward's
// scales) and (kq / S + 1) * 6 * W of checkpoints (S = 8, 4 above
// W = 256: mea_segment); in GAMMA (kq + 1) * W
// floats of match rows and 2 * kp4 scales instead; above W = 512 every
// mode runs realign_kernel and takes its slot (the states and the
// rescale inverses: at W = 1536 and 2048 the whole band's); a read that needs
// more than woff[r + 1] - woff[r] traps on the device.  The outputs by
// mode are those of realign_kernel, mea_kernel (DECODE, DECODE_GAMMA:
// `out1` score, `out2` direction codes, `out3` the gamma band) and
// gamma_kernel (`out3` the gamma band); a pointer a mode does not write
// may be null.
extern "C" int np_realign_launch(int mode, const float* tables, const void* xyc,
                                 const void* m, const void* n, int nreads,
                                 int k_pad, int W, int wl, void* ws, const void* woff,
                                 void* loglik, void* out1, void* out2,
                                 void* out3, void* stream) {
  if (nreads <= 0 || k_pad < 2 || k_pad % 2 != 0 || wl < 1 || wl > W)
    return (int)cudaErrorInvalidValue;
  Tables t;
  for (int i = 0; i < NTAB; ++i) t.v[i] = tables[i];
  cudaStream_t s = (cudaStream_t)stream;
#define NP_WIDTH(WIDTH, C, G, CB)                                                              \
  if (W == WIDTH)                                                                              \
    return launch_width<C, G, CB>(mode, t, nreads, s, xyc, m, n, k_pad, wl, ws, woff, loglik, \
                                  out1, out2, out3);
  NP_WIDTH(2048, 4, 8, 2)
  NP_WIDTH(1536, 4, 6, 2)
  NP_WIDTH(1024, 4, 8, 1)
  NP_WIDTH(768, 4, 6, 1)
  NP_WIDTH(512, 4, 4, 1)
  NP_WIDTH(384, 4, 3, 1)
  NP_WIDTH(256, 4, 2, 1)
  NP_WIDTH(128, 4, 1, 1)
  NP_WIDTH(64, 2, 1, 1)
  NP_WIDTH(32, 1, 1, 1)
#undef NP_WIDTH
  return (int)cudaErrorInvalidValue;
}
