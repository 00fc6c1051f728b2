#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch
   version, and builds the kernels from ``nanopore_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel, each printing its
   ``ptxas -v`` registers and spills; the realign source holds the
   decode, EM, gamma, decode + gamma and exp modes, and each mode's
   registers, local memory (spills), static and dynamic shared memory
   and threads and reads a block at W = 64 and 32 are printed from the
   compiled kernel, with the pack kernel's, the Viterbi kernel's (its
   short and 5-way steps on the byte plane, and its full-plane step),
   the forward-only kernel's (its two-term and its 5-way gap sum) and
   each walker's shared memory a block, the Viterbi walker's for each
   plane).  Then the
   realign kernel's workspace guard (ROADMAP C8), in a child process
   (``chip_smoke.py --kend-guard``): a launch whose caller's kend is
   m + n passes, one whose kend is half of m + n must fail at the next
   synchronise (a trap on the device, which leaves the child's context
   unusable).  Then the CPU halves' two processes (``chip_smoke.py
   --cpu-halves 13,15,16,17,18,19`` and ``--cpu-halves 21,22``, no card
   visible, their logs in
   ``_build/smoke/cpu_halves/cpu-halves-<phases>_child.log``), started
   here and run beside every card phase: phase 13's reads are mapped on
   the card into their directory, and each runs, on its own copies of
   the seeded inputs, the CPU halves of its steps' card-against-CPU
   checks (``MappingEngine(device="cpu")``, ``realign --device cpu``,
   ``em_train(device="cpu")``), in the order the card phases reach
   them, each leaving its output as a file there that the card phase
   compares against (the same reads, widths and bars; a failure in
   either process fails the script).
2. Makes two seeded workloads of 512 reads of 5 kb (5 % deletions, 10 %
   substitutions, both strands, origin and strand in each read name): on
   a 1 Mb random reference for the mapping path, and on a 48,502-bp one
   (the length of lambda phage, the genome marginAlign's users train on)
   for the EM path.
3. Takes one realign batch of the mapping main path (the engine's own
   seeding, chaining and guide cigars; the preferred batch size, W = 64)
   and holds every kernel against its plain PyTorch version on the card:
   pack byte-identical, also on streams of random bytes (W = 64 and 32,
   k_pad 800: three chunks of 256 diagonals and part of a fourth);
   realign loglik within 1e-5 and score within 1e-4
   relative, cigars identical on at least 99 % of reads (a differing read
   must still agree in loglik and score: an MEA tie); walker ops
   identical.  Times each kernel with CUDA events beside its bound and
   the plain version's time.  Then the MEA walker on ragged card
   batches at W = 64 and 32 (seven reads of unequal length, one five
   times the median of the others, so B is not a multiple of the
   kernel's 4 reads a block; each of two reads alone; the seven with
   one read's m raised past k_pad), on the realign kernel's direction
   codes and on random ones (paths that leave the band): ops
   bit-identical to the plain walker's.  The mapping batch's decode must
   take one launch.  Then the decode modes' backward segments (8
   diagonals, csrc/realign.cu): decode and decode + gamma at W = 64 and
   32 on a batch whose m + n covers every residue mod 16 (odd ones end
   one diagonal below kq), with two reads shorter than a segment and one
   ~4x the others, and again with that read's m raised past k_pad:
   loglik, score, direction codes and gamma band bit-identical to the
   plain version's.
4. Maps the reads end to end with ``run_mapper("LastParams", ...)``
   twice (the second run is the warm one), with every launch counter
   set to 0 just before the warm run and read just after; each must be
   > 0, and >= 99 % of the reads' primary records must land at their
   origin.
5. EM path, kernel rows.  On the second workload's own data (mapped by
   the engine, chained): the pack kernel byte-identical to its plain
   version on the EM batch and on the realign batch; the realign
   kernel's EM mode against its plain version at W = 64 on the EM batch
   (windows of pad 256): loglik within 1e-5 relative, trans and emis
   within 3e-5 of each table's largest entry per read; the decode mode
   at W = 32 on the realign stage's fullest bucket (windows of pad 128)
   to the bars of step 3, the plain realign's cigars walked by the plain
   walker; and the walker kernel against its plain version on those
   W = 32 direction codes of the whole bucket, timed there.  The plain realign and walker run on the
   first 128 reads at the full diagonal count (a read's outputs do not
   depend on its batch); the kernels are timed on the full batch.  A
   chained record that ends ``<tail>D <k>I`` windows to the end of the
   reference, and under the random start its EM sums can leave the f32
   range (``align.em.representable``): kernel and plain version must
   then agree on which entries are finite, and the bars hold on the
   other reads.  The EM batch must take one launch; its short reads
   (m + n <= k_pad / 4), re-packed without the far-end windows, must
   give the kernel's sums bit for bit, and so must the whole batch under
   a quarter of the workspace cap (several launches).  The forward-only
   kernel on the EM batch: its loglik on the far-end windows (m + n >
   k_pad / 4) bit-identical to the plain version's; the reads it sent
   to its 5-way sum are printed.
6. EM path, end to end: ``run_mapper("LastParamsRealignEm", ...)`` with
   ``EmOptions(trials=2, iterations=10)`` twice, the second timed, every
   counter set to 0 before it.  Every kernel of the path (pack, realign
   decode, realign EM, walker) must have launched; the E-step's launches
   and device time per iteration are printed; the reads that
   ``em_train`` left out of its counts are printed; each trial's running
   likelihood must not decrease from its 2nd iteration on; the written
   model must load with rows that sum to 1; the SAM must hold one global
   record per read (pos 0, cigar consuming the whole reference and read)
   and >= 99 % of them must start within 100 bp of their origin on the
   right strand.
7. Posterior path.  Mutates the second workload's reference at 1 %
   (the pipeline's rate) with the port's ``mutate_reference_sequences``,
   which writes the SNP truth ``<ref>_Index.txt``, and maps the same
   reads (drawn from the unmutated sequence, ~53x) onto it twice:
   ``LastParams`` (local records) and ``LastParamsRealign`` (chain and
   realign at W = 32: global records).  Kernel rows, each kernel held
   against its plain version on the first 64 reads of the path's own
   batch and timed on the whole batch: the realign kernel's gamma mode
   at AlignmentUncertainty's fullest batch (W = 64, model blasr_hmm_0)
   and its decode + gamma mode at the rescore's fullest batch (W = 32),
   gamma within 5e-5 (bit-identity expected), loglik within 1e-5 and
   score within 1e-4 relative, direction codes identical on >= 99 % of
   reads; the gamma mode again on step 3's ragged batches and the
   segment batches at W = 64 and 32, loglik and the whole band
   bit-identical to the plain version's; its exp mode at the SNP caller's fullest batch (W = 64,
   threshold 1e-3), retire rows and flush within 5e-5, and again on up to
   3 reads of its longest bucket (the far-end windows of ROADMAP C6,
   with the same finite pattern); every other bucket is timed at the
   shape the SNP caller launches it; the pack kernel byte-identical on
   each batch.  Then, each with every counter set to
   0 just before it and read just after: ``AlignmentUncertainty`` on the
   local SAM (the weighted average posterior finite, in (0, 1]);
   ``MarginAlignSnpCaller`` on the realigned SAM (208 result nodes, every
   full-coverage fScore of a call set over the posteriors, marginAlign*,
   above 0.5; the 16 full-coverage fScores and, per model, the records
   with non-finite expectations are printed; under the default model the
   first 64 records of the exp check hold the plain version's
   expectations, scattered on the host, within rtol 1e-3 and atol 2e-3);
   ``realign_records(rescore=True)`` on 64 realigned records (every
   score finite, in [0, 1]).  Each prints its wall time and launches.
8. Viterbi kernels, in a second child process (``chip_smoke.py
   --viterbi``, its log in ``_build/smoke/viterbi_child.log``) started
   after step 4 and run beside steps 5-7, on the mapping main path's
   batch (step 3's, from the child's own copy of the seeded workload):
   the Viterbi kernel against its plain version on the first 128 reads at
   the full diagonal count (score within 1e-5 relative, fstate
   identical, the backpointer plane byte-identical on every lattice
   cell), the Viterbi walker against its plain version on the kernel's
   plane (op codes and end cells identical; every walk of the batch
   reaches the origin and its cigar consumes exactly m read and n
   reference bases), the forward-only kernel against its plain version
   (1e-5 relative) and against the realign kernel's decode loglik on the
   whole batch (1e-5 relative), and every Viterbi score at most the
   forward loglik (+1e-5 of it); each kernel timed on the whole batch.
   The Viterbi kernel also on step 3's ragged batches: under the default
   model (its short step) at W = 64 and 32, under that model with gap
   state 2's self-transition at 0 (still the short step) at W = 64, and
   with gap state 2 entered from nowhere (t[0 -> 2] = t[2 -> 2] = 0: its
   5-way step) at W = 64 and 32: score, fstate and the whole plane
   bit-identical to the plain version's (a one-read batch to its read's
   rows of the B = 7 batch's plain outputs; so in step 7); on the last
   model the short step, launched by hand, is shown to differ.
   The Viterbi walker also on step 3's ragged batches at W = 64 and 32,
   on the Viterbi kernel's plane (every walk but the capped read's
   reaches the origin) and on a random plane (walks that end short of
   it): ops and end cells bit-identical to the plain walker's.
   The forward-only kernel's reciprocal of the band maximum against
   ``__frcp_rn`` on every positive float (no bit may differ); then the
   kernel on step 3's ragged batches and the segment batches at W = 64
   and 32 under the default model and with t[0 -> 2] = t[2 -> 2] = 0
   (its two-term gap sum; no read may leave it) and with t[1 -> 2] > 0
   (its 5-way sum; the two-term sum, launched by hand, is shown to
   differ), and on reads with a run of N bases under a model whose N
   emissions are 1e-40 (the band maximum falls subnormal: each such
   read must go to the 5-way sum mid-read), loglik bit-identical to the
   plain version's.
   Then the forward-only kernel through its entry point
   (``prepared_from_pairs(..., prepared_cls=PreparedForward).run()``),
   with every counter set to 0 just before.
9. Viterbi path end to end: ``run_mapper("Viterbi", ...)`` on the
   mapping workload, cold then warm, every counter set to 0 before the
   warm run: pack, Viterbi and Viterbi walker launched, the realign and
   the MEA walker not, >= 99 % of primaries at their origin; then
   ``run_mapper("ViterbiRealign", ...)`` once on the 48,502-bp workload
   (counters set to 0 before it): one global record per read, >= 99 %
   within 100 bp of their origin on the right strand.
10. The pipeline, in a child process (``chip_smoke.py --pipeline``)
   started after step 1 and run beside steps 2-9 (its host work and
   their plain versions each hold a core; the card is idle most of
   either): a working directory of the second workload (its first 256
   reads of 5 kb, 5 % deletions, 10 % substitutions, on the 48,502-bp
   reference)
   in the reference layout, and ``nanopore_tpu_torch.cli.main(["run",
   wd, "--max-threads", "4", "--em-trials", "1", "--em-iterations",
   "5", "--meta-analyses", ...])`` in that process with every counter
   set to 0 just before: the 16 default mappers, 9 default analyses and
   5 default meta-analyses, with ``CoverageDepth`` and
   ``CustomTrackAssemblyHub`` beside them; the reads (256 where the
   other phases take 512) and the EM depth (1 trial x 5 iterations
   against the reference's 3 x 100) are the cuts.  Every
   task of ``pipeline_stats.json`` done on its first attempt (a retry
   that succeeds is no pass); every experiment's
   ``mapping.sam`` and the 9 ``DONE`` markers; each meta-analysis's data
   files; pack, realign, traceback, realign_em and realign_gamma
   launched, realign_exp, viterbi, viterbi_traceback and forward not;
   AlignmentUncertainty's weighted average posterior finite, in (0, 1],
   in every experiment; ``LastParamsChain``'s substitution share over
   ACGT within 5-9 % (10 % substitutions, a quarter of them the read's
   own base).  Then, on the ``LastParams*`` experiments' SAMs, again on
   the CPU: Substitutions and KmerAnalysis data files byte-identical,
   AlignmentUncertainty on each SAM's first 2 records within 1e-4 a
   read.  Prints the pipeline's wall, its task seconds by kind and by
   analysis, the five slowest tasks, its peak device memory and its
   launches; the parent waits for it after step 9.
11. ``rescue_2d`` on the card, in the same child after step 10: a
   working directory in the reference layout holding the pipeline's
   processed reference, its reads as both template and complement, a
   header-only template and complement SAM, and a ``LastParams``
   mapping of the reads (``run_mapper``; the pipeline runs no plain
   ``LastParams`` experiment) as the 2D SAM, so every mapped read is
   rescued in both read types; ``scripts.rescue_2d.main`` on them with
   every counter set to 0 just before: pack, realign and traceback
   launched, nothing else; each TSV one row per mapped 2D
   read; the forward-strand reads' (names ending ``_0``) median
   ``Identity`` above 0.85 (10 % substitutions, a quarter of them the
   read's own base: 7.5 % of aligned bases differ).  Then two of the
   jobs through ``rescue_metrics`` on the card and on the CPU as one
   batch: rows identical to each other and to the script's.
12. The multi-host pipeline, in the same child after step 11: two rank
   processes (``chip_smoke.py --rank <i> <port> <wd> <out>``), both on
   this card, each under ``NANOPORE_TPU_COORDINATOR=localhost:<port>``,
   ``NANOPORE_TPU_NUM_PROCESSES=2`` and its own
   ``NANOPORE_TPU_PROCESS_ID``, each calling ``cli.main(["run", wd,
   "--max-threads", "4", "--mappers", "LastParamsChain,
   LastParamsRealignEm", "--analyses", "GlobalCoverage,Substitutions",
   "--meta-analyses", "CoverageSummary", "--em-trials", "1",
   "--em-iterations", "5"])`` with every counter set to 0 just before,
   on a fresh working directory of step 10's reads and reference (the
   EM depth is step 10's cut).  The mesh is dp 2 x trial 1: each rank
   maps, trains on and realigns its half of the reads, and the E-step's
   float64 sums all-reduce over gloo.  Both ranks exit 0; every task of
   both ranks' stats files done on its first attempt; no shard litter;
   ``LastParamsChain``'s ``mapping.sam`` byte-identical to step 10's;
   the ``LastParamsRealignEm`` model (``hmm.txt_unnormalised``) within
   1e-9 relative of step 10's and its records equal to step 10's in
   their first four fields; on each rank pack, realign, traceback and
   realign_em launched and nothing else.  Prints the phase's wall and
   each rank's launches.
13. Band widths the kernels are not built for (ROADMAP C9, C10), in
   the child of step 8 after it (``chip_smoke.py --widths`` runs this
   step alone): 64 reads of 700-1300 bases drawn from the 48,502-bp
   reference (5 % deletions, 10 % substitutions), mapped with
   ``LastParams`` and chained, in windows of pad 128 (the realign
   stage's).  At live widths 21 (the reference's production band) and 48,
   laid into W = 32 and W = 64 with their dead lanes sentinel, every
   kernel against its plain version in that layout, to the bars of steps
   3, 5, 7 and 8: the pack byte-identical (its dead lanes all sentinel);
   decode and decode + gamma (loglik 1e-5, score 1e-4 relative,
   direction codes identical on >= 99 % of reads and DIR_NONE in every
   dead lane, gamma 5e-5); the MEA walker's ops identical, no walk
   leaving the live band; the EM mode (loglik 1e-5, trans and emis 3e-5
   of each table's largest entry per read); the gamma mode (5e-5); the
   exp mode (retire rows and flush 5e-5, the flush 0 in the dead lanes);
   the Viterbi kernel (score 1e-5 relative, the plane byte-identical)
   and its walker (ops and end cells identical); the forward-only kernel
   (loglik 1e-5 relative).  Each kernel timed with CUDA events at the
   live width, its bound at the live width, and again on the same reads
   as a band of the layout's full width.  Then, each with every counter
   set to 0 just before: ``cli.main(["realign", ..., "--band-width",
   "21"])`` on 8 of the reads (4 shorter than 1,000 bases, 4 longer:
   two window shapes, so two batches): pack, realign and traceback
   launched more than once, nothing else, and the SAM identical to the
   same command's with ``--device cpu``; ``em_train`` at
   ``EmOptions(band_width=48, trials=1, iterations=2)`` on 16 chained
   reads: the model within 3e-5 relative of the CPU's (both CPU runs in
   the CPU halves' process, as those of steps 15-19).
14. The full plane (a model outside the canonical fiveState structure,
   ROADMAP C7), in the child of step 8 after step 13 (``chip_smoke.py
   --full-plane`` runs this step alone), under two non-canonical models:
   tests/test_viterbi.py's (the default with t[1 -> 2] = 0.05, its row
   renormalised) and a dense random one (every transition > 0).  The
   Viterbi kernel's full-plane step against ``viterbi_forward_full_plain``
   on the first 128 reads of step 3's mapping batch (W = 64) and on step
   3's ragged batches at W = 32: score, fstate and the whole int16 plane
   bit-identical; the walker's full-plane walk of the kernel's plane
   against the plain walker (ops and end cells identical; every walk of
   the mapping batch reaches the origin, its cigar consuming exactly m
   and n), and on random full planes of the ragged batch at W = 64 and
   32.  Both timed on the whole mapping batch under the first model,
   beside their bounds and the plain versions' times.  Then
   ``MappingEngine(model=<the first model>, decode="viterbi")`` on 32
   reads of the mapping workload, on the card (every counter set to 0
   just before) and with ``device="cpu"``: records equal; pack and the
   full-plane Viterbi and walk launched, nothing else (the byte-plane
   Viterbi and walker 0).  In every earlier run the full-plane counters
   must be 0: no canonical model takes the full plane.
15. Band widths 65 to 128 (ROADMAP C10), in the child of step 8 after
   step 14 (``chip_smoke.py --wide`` runs this step alone): every
   kernel at W = 128 (C = 4 band cells a lane).  The W = 128
   instantiations' registers, local memory and shared memory are
   printed after the build.  On step 3's mapping batch (512 reads, the
   full band of 128 lanes): the pack byte-identical and the walker's ops
   identical on every read, the decode to step 3's bars on the first 128
   reads at the full diagonal count, in as many launches as its
   workspace plan (the 8 GiB cap: two at this width); the Viterbi
   kernel's short and 5-way steps (the default model) and its full plane
   (step 14's first model) with score, fstate and the whole plane
   bit-identical to the plain version's on the first 128 reads, the
   walker on each plane with ops and end cells identical on every read
   (every walk reaching the origin), the forward-only kernel's two-term
   and 5-way sums with the loglik within 1e-5 relative of the plain
   version's on the first 128 reads; each timed on the whole batch.
   ``MappingEngine(band_width=128)`` (MEA decode) on the mapping
   workload, cold then warm, every counter set to 0 before the warm run:
   >= 99 % of primaries at their origin; pack, realign and traceback
   launched, nothing else; and on 32 of its reads on the card and with
   ``device="cpu"``: records equal, the same launches.  On step 13's 64
   reads at live width 96 in W = 128: every kernel (every realign mode,
   the pack, both walkers, the Viterbi and the forward-only kernel)
   against its plain version to step 13's bars, the dead lanes checked,
   each timed at w = 96 and on the same reads at the full 128.  Then, each with every counter set to 0 just before:
   ``cli realign --band-width 96`` on step 13's 8 records against
   ``--device cpu`` (records identical; pack, realign and traceback
   launched, nothing else); ``em_train`` at ``EmOptions(band_width=96,
   trials=1, iterations=2)`` on 16 chained reads against the CPU (3e-5
   relative); ``MappingEngine(band_width=96, decode="viterbi")`` on 32
   reads on the card and with ``device="cpu"``: records equal; pack,
   viterbi and viterbi_traceback launched, nothing else; and
   ``MappingEngine(band_width=128, decode="viterbi")`` on the mapping
   workload, cold then warm: >= 99 % of primaries at their origin, the
   same launches.
16. Band widths 129 to 256 (ROADMAP C11, first half: the MEA path), in
   the child of step 10 after step 12 (that process's cached card
   memory released first: the card is shared by three processes), on
   its own copies of the seeded mapping workload and of step 13's reads
   (``chip_smoke.py --wider`` runs this step alone after the build):
   the W = 256 builds of the
   pack, the realign kernel in every mode (the band held by a pair of
   warps) and the MEA walker, whose registers, local memory and shared
   memory are printed after the build.  On step 3's mapping batch (512
   reads, the full band of 256 lanes): the pack byte-identical and the
   walker's ops identical on every read, the decode to step 3's bars on
   the first 32 reads at the full diagonal count, in as many launches as
   its workspace plan (the 8 GiB cap: four at this width); each timed on
   the whole batch.  ``MappingEngine(band_width=256)`` (MEA decode) on
   the mapping workload, cold then warm, every counter set to 0 before
   the warm run: >= 99 % of primaries at their origin; pack, realign and
   traceback launched, nothing else.  On step 13's 64 reads at live
   width 200 in W = 256 and at the full 256: the pack, every realign
   mode and the MEA walker against their plain versions to step 13's
   bars, the dead lanes checked, each timed there and as the same reads'
   full 256-lane band.  Then, each with every counter set to 0 just
   before: ``MappingEngine(band_width=200)`` on 32 reads of the mapping
   workload on the card and with ``device="cpu"`` (records equal; pack,
   realign and traceback launched, nothing else); ``cli realign
   --band-width 200`` on step 13's 8 records against ``--device cpu``
   (records identical; the same launches); ``em_train`` at
   ``EmOptions(band_width=200, trials=1, iterations=2)`` on 16 chained
   reads against the CPU (3e-5 relative).  On the card every path
   refuses 1025 (``MappingEngine`` with the MEA decode,
   ``PreparedRealign``; ``MappingEngine`` with the Viterbi decode,
   ``PreparedViterbi``, ``PreparedForward``), naming C11.
17. Band widths 129 to 256 on the Viterbi path (ROADMAP C11, second
   step), in the child of step 8 after step 15 (its cached card memory
   released first), on that child's copies of the mapping workload and
   of step 13's reads (``chip_smoke.py --viterbi-wider`` runs this step
   alone after the build and the W = 256 attributes, on its own
   copies): the W = 256 builds of the Viterbi kernel
   (its short and 5-way steps and its full plane, the band held by a
   pair of warps), the Viterbi walker on both planes and the
   forward-only kernel (both gap sums, the band on a pair of warps),
   whose registers, local memory and shared memory are printed after
   the build.  On step 3's mapping batch (512 reads, the full band of
   256 lanes), as in step 15: the Viterbi's two steps (the default
   model) and its full plane (step 14's first model) with score, fstate
   and the whole plane bit-identical to the plain version's on the first
   32 reads, the walker on each plane with ops and end cells identical
   on every read (every walk reaching the origin), the forward-only
   kernel's two sums within 1e-5 relative of the plain version's loglik
   on the first 32 reads; each timed on the whole batch.  On step 13's
   64 reads at live width 200 and at the full 256: the Viterbi, its
   walker and the forward-only kernel to step 13's bars, each timed
   there and as the same reads' full 256-lane band.  The forward-only
   kernel's pair vote: reads whose N in the window, under a model whose
   first delete state emits an N with NaN, fail the two-term check
   first in the upper warp's cells alone (a plain two-term recursion
   checked warp by warp shows it); the kernel must send each whole read
   to the 5-way sum from that chunk's start and give the plain
   version's loglik (NaN where it is NaN: a non-finite gap state keeps
   a NaN at the band's top in the 5-way sum, so no such read ends
   finite).  Its finite switch: reads with runs of N, under N emissions
   of 1e-37, whose band maximum (the pair's) falls to a subnormal with a
   finite inverse; at least three reads switch mid-read, both warps roll
   back and go on with the 5-way sum together, and every loglik is
   finite and the plain version's bit for bit.  Then, each with every
   counter set to 0 just before: ``MappingEngine(band_width=256,
   decode="viterbi")`` on the mapping workload, cold then warm: >= 99 %
   of primaries at their origin; pack, viterbi and viterbi_traceback
   launched, nothing else; and ``MappingEngine(band_width=200,
   decode="viterbi")`` on 32 reads on the card and with
   ``device="cpu"``: records equal, the same launches.
18. Band widths 257 to 512 (ROADMAP C11, third step: the MEA path), in
   the child of step 10 after step 16 (its cached card memory released
   first; on step 16's copies of the mapping workload and of step 13's
   reads); ``chip_smoke.py --widest`` runs this step alone after the build and the W = 384 and
   512 attributes, on its own copies: the W = 384 and 512
   builds of the pack, the realign kernel in every mode (the band held
   by a group of three or four warps; the decode's backward segment 4
   diagonals) and the MEA walker (one read a block), whose registers,
   local memory and shared memory are printed after the build.  On step
   3's mapping batch (512 reads, the full band of 512 lanes): the pack
   byte-identical and the walker's ops identical on every read, the
   decode to step 3's bars on the first 16 reads at the full diagonal
   count, in as many launches as its workspace plan (the 8 GiB cap:
   eight at this width); each timed on the whole batch.
   ``MappingEngine(band_width=512)`` (MEA decode) on the mapping
   workload, cold then warm, every counter set to 0 before the warm
   run: >= 99 % of primaries at their origin; pack, realign and
   traceback launched, nothing else.  On step 13's 64 reads at live
   widths 300 (in W = 384), 384, 450 (in W = 512) and 512: the pack,
   every realign mode and the MEA walker against their plain versions
   to step 13's bars, the dead lanes checked, each timed there and as
   the same reads' full band of the layout.  Then, each with every
   counter set to 0 just before: ``MappingEngine(band_width=450)`` on 32
   reads on the card against ``device="cpu"`` (records equal; pack,
   realign and traceback launched, nothing else); ``cli realign
   --band-width 450`` on step 13's 8 records against ``--device cpu``
   (records identical; the same launches); ``em_train`` at
   ``EmOptions(band_width=450, trials=1, iterations=2)`` on 16 chained
   reads against the CPU (3e-5 relative); and step 16's refusals.
19. Band widths 257 to 512 on the Viterbi path (ROADMAP C11, fourth
   step), in the child of step 10 after step 18 (its cached card memory
   released first; on step 16's copies of the mapping workload and of
   step 13's reads; ``chip_smoke.py --viterbi-widest`` runs this step
   alone after the build and the W = 384 and 512 attributes, on its own
   copies): the W = 384 and 512 builds of the Viterbi kernel (its
   short and 5-way steps and its full plane, the band held by a group of
   three or four warps), the Viterbi walker on both planes (one read a
   block; the full plane's rows in chunks of 64 diagonals) and the
   forward-only kernel (both gap sums, the band on a group of warps, its
   stage in dynamic shared memory), whose registers, local memory,
   static and dynamic shared memory and threads and reads a block are
   printed after the build.  On step 3's mapping batch (512 reads, the
   full band of 512 lanes), as in step 17: the Viterbi's two steps (the
   default model) and its full plane (step 14's first model) with score,
   fstate and the whole plane bit-identical to the plain version's on
   the first 16 reads, the walker on each plane with ops and end cells
   identical on every read (every walk reaching the origin), the
   forward-only kernel's two sums within 1e-5 relative of the plain
   version's loglik on the first 16 reads; each timed on the whole
   batch.  On step 13's 64 reads at live widths 300 (in W = 384) and
   450 (in W = 512), dead lanes in the top warp: the Viterbi's short
   step, its walker and the forward-only kernel's two-term sum (the
   default model) to step 13's bars, and the Viterbi's 5-way step and
   the forward-only kernel's 5-way sum against the same plain runs, the
   full plane and its walk (step 14's first model) bit for bit, every
   walk checked to stay in the live band; each timed there and as the
   same reads' full band of the layout (so every W = 384 build is held
   to its plain version here, every W = 512 one on the mapping batch
   too).  The forward-only kernel's group
   vote at w = 300 and 450 (step 17's pair vote case built for the
   width: its NaN starts in the top warp's live cells, 256-299 and
   384-449, and the two-term check first fails there alone) and its
   finite switch in 512 lanes (:data:`N_RUNS_WIDEST`), as in step 17.
   Then, each with every counter set to 0 just before:
   ``MappingEngine(band_width=512, decode="viterbi")`` on the mapping
   workload, cold then warm: >= 99 % of primaries at their origin; pack,
   viterbi and viterbi_traceback launched, nothing else;
   ``MappingEngine(band_width=450, decode="viterbi")`` on 32 reads on
   the card and with ``device="cpu"``: records equal, the same
   launches; and step 16's refusals.
21. Band widths 513 to 1024 (ROADMAP C11, fifth step: the MEA path), in
   this process after step 9 (its cached card memory released first; on
   step 3's mapping batch and a copy of step 13's reads);
   ``chip_smoke.py --widest-1024`` runs this step alone after the build
   and the W = 768 and 1024 attributes, on its own copies: the W = 768
   and 1024 builds of the pack (a row of 1024 cells is 64 threads' 16),
   the realign kernel in every mode (above 512 each mode runs the
   forward, then the backward, on one group of six or eight warps, in
   chunks of 4 diagonals, the decode's MEA step and the gamma rows
   formed in the backward) and the MEA walker (one read a block, chunks
   of 64 diagonals), whose registers, local memory and shared memory
   are printed after the build.  On step 3's mapping batch (512 reads,
   the full band of 1024 lanes): the pack byte-identical and the
   walker's ops identical on every read, the decode to step 3's bars on
   the first 4 reads at the full diagonal count, in as many launches as
   its workspace plan (the 8 GiB cap over the EM mode's slot: 13 at
   this width); each timed on the whole batch.
   ``MappingEngine(band_width=1024)`` on the mapping workload, cold then
   warm, every counter set to 0 before the warm run: >= 99 % of
   primaries at their origin; pack, realign and traceback launched,
   nothing else.  On step 13's 64 reads at live widths 600 (in
   W = 768), 768, 900 (in W = 1024) and 1024: the pack, every realign
   mode and the MEA walker against their plain versions to step 13's
   bars, the dead lanes checked, each timed there and as the same
   reads' full band of the layout.  Then, each with every counter set
   to 0 just before: ``MappingEngine(band_width=900)`` on 32 reads on
   the card against ``device="cpu"`` (records equal; pack, realign and
   traceback launched, nothing else); ``cli realign --band-width 900``
   on step 13's 8 records against ``--device cpu`` (records identical;
   the same launches); ``em_train`` at ``EmOptions(band_width=900,
   trials=1, iterations=2)`` (window pad 32) on 16 chained reads against
   the CPU (3e-5 relative); and step 16's refusals.
22. Band widths 513 to 1024 on the Viterbi path (ROADMAP C11, sixth
   step), in the child of step 8 after step 17 (its cached card memory
   released first; on that child's copies of the mapping workload and
   of step 13's reads; ``chip_smoke.py --viterbi-w1024`` runs this step
   alone after the build and the W = 768 and 1024 attributes, on its own
   copies): the W = 768 and 1024 builds of the Viterbi kernel (its short
   and 5-way steps and its full plane, the band held by a group of six
   or eight warps, its stage in dynamic shared memory), the Viterbi
   walker on both planes (one read a block; the byte rows in chunks of
   64 diagonals, the full plane's 16-bit rows in chunks of 32) and the
   forward-only kernel (both gap sums on a group of six or eight warps),
   whose registers, local memory, static and dynamic shared memory and
   threads and reads a block are printed after the build.  On step 3's
   mapping batch (512 reads, the full band of 1024 lanes), as in step
   19: the Viterbi's two steps and its full plane bit-identical to the
   plain version's on the first 4 reads, the walker on each plane on
   every read, the forward-only kernel's two sums on the first 4 reads;
   each timed on the whole batch, the card's peak memory printed.  On
   step 13's 64 reads at live widths 600 (in W = 768, its top warp all
   dead lanes), 768, 900 (in W = 1024, one live lane in the top warp)
   and 1024, every step against the same plain runs as in step 19, every
   walk checked to stay in the live band, each timed there and as the
   same reads' full band of the layout.  The forward-only kernel's group
   vote at 600 and 900 (the NaN starting in the top live warp's cells,
   512-599 and 896-899, which alone fail the first failing chunk's
   check) and its finite switch in 1024 lanes (:data:`N_RUNS_W1024`).
   Then, each with every counter set to 0 just before:
   ``MappingEngine(band_width=1024, decode="viterbi")`` on the mapping
   workload, cold then warm: >= 99 % of primaries at their origin; pack,
   viterbi and viterbi_traceback launched, nothing else;
   ``MappingEngine(band_width=900, decode="viterbi")`` on 32 reads on
   the card and with ``device="cpu"``: records equal, the same
   launches; and step 16's refusals.
23. Band widths 1025 to 2048 (ROADMAP C11, seventh step: the MEA
   path), in the child of step 8 after step 22 (its cached card memory
   released first; on that child's copies of the mapping workload and of
   step 13's reads; ``chip_smoke.py --mea-w2048`` runs this step alone
   after the build and the W = 1536 and 2048 attributes, on its own
   copies): the W = 1536 and 2048 builds of the pack (a row of 2048
   cells is the block's 128 threads' 16), the realign kernel in every
   mode (a read's band on a thread-block cluster of two blocks of six or
   eight warps, one an SM, csrc/group.cuh's cluster tier: each block
   the W = 768 or 1024 build's columns and stage, every exchange a
   cluster barrier, the EM sums' first fold block 1's warps onto block
   0's through distributed shared memory) and the MEA walker (one read a
   block, chunks of 32 diagonals), whose registers, local memory, shared
   memory and clusters resident at once are printed after the build.  On
   step 3's mapping batch (512 reads, the full band of 2048 lanes): the
   pack byte-identical and the decode to step 3's bars on the first 4
   reads at the full diagonal count, in as many launches as its
   workspace plan (the 8 GiB cap over the EM mode's slot: ~26 at this
   width), the walker's ops identical on every read and every walk from
   the origin to its read's end cell; each timed on the whole batch, the
   process's peak card memory printed.
   ``MappingEngine(band_width=2048)`` on the mapping workload, cold then
   warm, every counter set to 0 before the warm run: >= 99 % of
   primaries at their origin; pack, realign and traceback launched,
   nothing else.  On step 13's 64 reads at live widths 1100 (in
   W = 1536), 1536, 1800 (in W = 2048) and 2048: the pack, every realign
   mode and the MEA walker against their plain versions to step 13's
   bars, the dead lanes checked, each timed there and as the same
   reads' full band of the layout.  Then, each with every counter set
   to 0 just before: ``MappingEngine(band_width=1800)`` on 32 reads on
   the card against ``device="cpu"`` (records equal; pack, realign and
   traceback launched, nothing else); ``cli realign --band-width 1800``
   on step 13's 8 records against ``--device cpu`` (records identical;
   the same launches); ``em_train`` at ``EmOptions(band_width=1800,
   trials=1, iterations=2)`` (window pad 32) on 16 chained reads against
   the CPU (3e-5 relative); and the refusals (the MEA path's of 2049 and
   the Viterbi path's of 1025, in steps 16, 18, 19 and 21-23).
20. Prints the script's wall time, one ``{"kernels": [...]}`` line (a
   ``launches_pipeline_path``, a ``launches_rescue_2d_path``, a
   ``launches_distributed_path``, the sum over the two ranks, a
   ``launches_widths_realign_path``, a ``launches_widths_em_path``, a
   ``launches_full_plane_path`` and step 15's ``launches_wide_map_path``,
   ``launches_wide_engine_path``, ``launches_wide_realign_path``,
   ``launches_wide_em_path``, ``launches_wide_viterbi_engine_path``,
   ``launches_wide_viterbi_map_path`` and step 16's
   ``launches_wider_map_path``, ``launches_wider_engine_path``,
   ``launches_wider_realign_path``, ``launches_wider_em_path`` and step
   17's ``launches_viterbi_wider_map_path`` and
   ``launches_viterbi_wider_engine_path`` and step 18's
   ``launches_widest_map_path``, ``launches_widest_engine_path``,
   ``launches_widest_realign_path`` and ``launches_widest_em_path`` and
   step 19's ``launches_viterbi_widest_map_path`` and
   ``launches_viterbi_widest_engine_path`` and step 21's
   ``launches_w1024_map_path``, ``launches_w1024_engine_path``,
   ``launches_w1024_realign_path`` and ``launches_w1024_em_path`` and
   step 22's ``launches_viterbi_w1024_map_path`` and
   ``launches_viterbi_w1024_engine_path`` and step 23's
   ``launches_w2048_map_path``, ``launches_w2048_engine_path``,
   ``launches_w2048_realign_path`` and ``launches_w2048_em_path`` on
   every row, step 13's
   ``*_w21`` and ``*_w48`` numbers, step 15's ``*_w96`` and ``*_w128``
   numbers and W = 128 attributes, steps 16's and 17's ``*_w200``,
   ``*_w256`` (the mapping batch) and ``*_live256`` (step 13's reads at
   the full 256) numbers and W = 256 attributes on each path's rows,
   and steps 18's and 19's ``*_w300`` and ``*_w450`` (step 13's reads;
   their ``ms_full_*`` the full band of 384 and 512 lanes), step 18's
   ``*_live384`` and ``*_live512`` and both steps' ``*_w512`` (the
   mapping batch) numbers and W = 384 and 512 attributes on each path's
   rows (``*_5way_*`` the other step or sum), steps 21's and 22's
   ``*_w600``, ``*_w900``, ``*_live768``, ``*_live1024`` and ``*_w1024``
   (the mapping batch) numbers and W = 768 and 1024 attributes on each
   path's rows, step 23's ``*_w1100``, ``*_w1800``, ``*_live1536``,
   ``*_live2048`` and ``*_w2048`` (the mapping batch) numbers and
   W = 1536 and 2048 attributes (with ``clusters_resident_*``) on the
   MEA path's rows;
   ``viterbi_full`` and ``viterbi_traceback_full`` the full-plane modes
   of the Viterbi kernel and its walker) and, last, ``{"ok": true,
   "device": {...}}``.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without a CUDA device or without the
``nanopore_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
REF_LEN = 1_000_000
EM_REF_LEN = 48_502
N_READS = 512
PIPELINE_READS = 256  # phase 10's reads (its depth cut: the script's time)
READ_LEN = 5000
W = 64
W_REALIGN = 32  # the realign presets' band
PLAIN_READS = 128  # reads the EM path's plain versions run on
POST_PLAIN_READS = 64  # reads the posterior path's plain versions run on
RESCORE_READS = 64  # records realign_records(rescore=True) rescores
MUTATION_RATE = 0.01  # the pipeline's (analyses/mutate_reference.py)
SNP_THRESHOLD = 1e-3  # analyses/snp_caller.py::POSTERIOR_THRESHOLD
# phase 13: live band widths laid into the W = 32 and W = 64 kernels
LIVE_WIDTHS = (21, 48)  # the reference's production band, one above 32
WIDTH_READS = 64  # of 80 drawn: those whose window misses the far end
WIDTH_READ_LENS = (700, 1300)
WIDTH_MAX_K = 4096  # m + n of a window that does not reach the far end
WIDTH_CLI_RECORDS = 4  # reads on each side of 1,000 bases
WIDTH_EM_READS = 16
# phase 14: reads of the mapping workload the Viterbi engine maps with a
# non-canonical model, card against CPU
FULL_ENGINE_READS = 32
# phase 15: band widths 65 to 128 in the W = 128 kernels of the MEA path
WIDE_W = 128
WIDE_LIVE = 96  # a live width with dead lanes (96..127)
WIDE_ENGINE_READS = 32  # reads the engine maps on the card and the CPU
# phase 16: band widths 129 to 256 in the W = 256 kernels of the MEA path
WIDER_W = 256
WIDER_LIVE = 200  # a live width with dead lanes (200..255)
WIDER_PLAIN_READS = 32  # reads of the mapping batch the plain decode runs on
# phase 18: band widths 257 to 512 in the W = 384 and 512 kernels of the
# MEA path
WIDEST_W = (384, 512)
WIDEST_LIVE = (300, 384, 450, 512)  # dead lanes in the top warp; none; ...
WIDEST_DEAD = (300, 450)  # of those, the two with dead lanes
WIDEST_CPU = 450  # the live width of its card-against-CPU checks
WIDEST_PLAIN_READS = 16  # reads of the mapping batch the plain decode runs on
# phase 21: band widths 513 to 1024 in the W = 768 and 1024 kernels of
# the MEA path (every realign mode on one group of 6 or 8 warps)
W1024 = (768, 1024)
W1024_LIVE = (600, 768, 900, 1024)  # dead lanes in W = 768; none; ...
W1024_CPU = 900  # the live width of its card-against-CPU checks
# reads of the mapping batch the plain versions run on (a depth cut for
# the script's time, which phase 23 shares)
W1024_PLAIN_READS = 4
# phase 22: the Viterbi path at 513 to 1024 (K4 and K6 on one group of 6
# or 8 warps); its live widths and plain reads are phase 21's
W1024_DEAD = (600, 900)  # the top warp all dead; one live lane in it
# phase 23: band widths 1025 to 2048 in the W = 1536 and 2048 kernels of
# the MEA path (a read's band on a cluster of two blocks, one an SM)
W2048 = (1536, 2048)
W2048_LIVE = (1100, 1536, 1800, 2048)  # dead lanes in W = 1536; none; ...
W2048_CPU = 1800  # the live width of its card-against-CPU checks
W2048_PLAIN_READS = 4  # reads of the mapping batch the plain versions run on
# em_train's window pad above W = 256: at the default 256 no read's sums
# stay in f32 under the random start (0 of 16 at 300, 384 and 450, on
# either device, as the JAX package's scan loses them), and an iteration
# that keeps no read raises; at the CPU tests' 32 some reads are kept
EM_WIDEST_PAD = 32
# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per band cell per diagonal of the decode-mode realign
# (csrc/realign.cu): forward 45 transition + 6 emission + 5 rescale
# (amortised), backward 6 destination + 45 transition + 5 rescale + 12
# posterior + 11 MEA
REALIGN_OPS_PER_CELL = 56 + 79
# EM mode: the same forward; backward 6 destination + 45 transition + 5
# rescale + 10 posterior + 55 transition products (5 + 25 multiplies, 25
# adds) + 5 bin adds (one gamma into one bin for each state), no MEA
REALIGN_EM_OPS_PER_CELL = 56 + 126
# gamma mode: the same forward; backward 6 destination + 45 transition +
# 5 rescale + 2 for the match state's posterior, no MEA (decode + gamma
# needs no more than decode: the MEA reads that posterior too)
REALIGN_GAMMA_OPS_PER_CELL = 56 + 58
# exp mode: the gamma mode's backward + 3 to bin (a compare, a select,
# one add of the gamma into its base's bin)
REALIGN_EXP_OPS_PER_CELL = 56 + 61
# Viterbi (csrc/viterbi.cu), 5-way step: 5 destinations x (5 adds, 4
# compares, 4 maxima, 4 argmax selects) for the predecessors, then 5 adds
# and 5 maxima for the emissions (their validity select depends on the
# code alone: a lookup)
VITERBI_OPS_PER_CELL = 5 * 17 + 10
# the short step, which every shipped model takes (ops/viterbi.short_step):
# the match destination as above, each gap destination 2 adds, a max and a
# compare (its from-self bit), then the emissions
VITERBI_SHORT_OPS_PER_CELL = 17 + 4 * 4 + 10
# forward only (csrc/forward.cu), its 5-way gap sum: the realign kernel's
# forward, 45 transition + 6 emission + 5 rescale (amortised)
FORWARD_OPS_PER_CELL = 56
# its two-term gap sum, which every shipped model takes
# (ops/forward.two_term_sum): the match state's 9, 3 for each gap state
# (two multiplies and an add), then the same 6 + 5 (the kernel's check of
# each pair, 4 adds a cell a diagonal, is not the function's work)
FORWARD_SHORT_OPS_PER_CELL = 9 + 4 * 3 + 6 + 5


def fail(msg: str) -> None:
    raise SystemExit("chip_smoke: FAILED: " + msg)


def write_workload(workdir: str, ref_len: int, n_reads: int = N_READS,
                   read_lens=None):
    """A random reference of ``ref_len`` and ``n_reads`` noisy 5 kb reads
    (names r<i>_<start>_<strand>); with ``read_lens`` (lo, hi), reads of
    lengths drawn uniformly from lo..hi by a second generator (the
    reference is the same)."""
    from nanopore_tpu_torch.io.encoding import decode, revcomp_codes

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    ref = rng.integers(0, 4, ref_len).astype(np.int8)
    fa = os.path.join(workdir, "ref.fa")
    seq = decode(ref)
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, len(seq), 80):
            fh.write(seq[i:i + 80] + "\n")
    fq = os.path.join(workdir, "reads.fq")
    if read_lens is not None:
        rng = np.random.default_rng(SEED + 1)
    with open(fq, "w") as fh:
        for r in range(n_reads):
            length = READ_LEN if read_lens is None else int(
                rng.integers(read_lens[0], read_lens[1] + 1))
            start = int(rng.integers(0, ref_len - length))
            x = ref[start:start + length]
            y = x[rng.random(length) > 0.05]
            sub = rng.random(len(y)) < 0.10
            y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
            strand = int(rng.integers(0, 2))
            if strand:
                y = revcomp_codes(y)
            s = decode(y)
            fh.write("@r%d_%d_%d\n%s\n+\n%s\n" % (r, start, strand, s,
                                                    "I" * len(s)))
    return fa, fq


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean ms of ``reps`` calls back to back, after one untimed call
    (``warmup``), whose own time and the caching allocator's new device
    segments (cudaMalloc) and retries during it are printed."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    first = None
    if warmup:
        keys = ("segment.all.allocated", "num_alloc_retries")
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        first = start.elapsed_time(end)
        after = torch.cuda.memory_stats()
        grew = [after.get(k, 0) - before.get(k, 0) for k in keys]
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    if warmup:
        print("  timing: first call %.3f ms (%d new device segments, %d "
              "allocator retries), then %.3f ms a call over %d"
              % (first, grew[0], grew[1], ms, reps))
    return ms


def timed(fn):
    """(result, ms) of one call, timed with CUDA events."""
    box = []
    ms = cuda_ms(lambda: box.append(fn()), 1, warmup=False)
    return box[0], ms


def launches_per_call(counter, fn) -> int:
    """Kernel launches one wrapper call makes (a batch's worth)."""
    before = counter.count
    fn()
    return counter.count - before


def main_path_batch(engine, fq: str, batch_size: int):
    """One realign batch as the engine forms it: primary candidates of
    the first reads, seeded and chained by the engine itself."""
    from nanopore_tpu_torch.io.seqio import fastq_read_raw

    cands = []
    for header, seq, _ in fastq_read_raw(fq):
        cands.extend(
            c for c in engine._candidates_for_read(header.split()[0], seq)
            if c.primary
        )
        if len(cands) >= batch_size:
            break
    return engine.candidate_pairs(cands[:batch_size])


def ragged_pairs(seed: int):
    """Seven (window, read, guide) pairs of unequal lengths, one read
    five times the median of the others (10 % substitutions, a run of 8
    deletions in every read, guided by one M run then the rest as D)."""
    from nanopore_tpu_torch.io.sam import CIG

    rng = np.random.default_rng(seed)
    pairs = []
    for L in (380, 410, 430, 2050, 395, 440, 415):
        x = rng.integers(0, 4, L).astype(np.int8)
        cut = int(rng.integers(L // 4, L // 2))
        y = np.concatenate([x[:cut], x[cut + 8:]])
        sub = rng.random(len(y)) < 0.10
        y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
        pairs.append((x, y, [(CIG.M, len(y)), (CIG.D, L - len(y))]))
    return pairs


# the one-read ragged batches and their read's row in the B = 7 batch
RAGGED_B1_ROWS = {"B1 long": 3, "B1 short": 0}


def ragged_batches(dev, W_: int):
    """The ragged card batches of the walker checks at band width W_:
    (name, xyc, m, n) for the seven reads of :func:`ragged_pairs`, the
    long read alone (B = 1), a short read alone, and the seven with the
    long read's m raised past k_pad (a capped read, cut at k_pad)."""
    import torch

    pairs = ragged_pairs(SEED + W_)
    xyc, m, n, prep = device_batch(pairs, W_, None, dev, "ragged batch",
                                   check_pack=False)
    out = [("B7", xyc, m, n)]
    for name, r in RAGGED_B1_ROWS.items():
        out.append((name,) + tuple(t[r:r + 1].contiguous()
                                   for t in (xyc, m, n)))
    capped = m.clone()
    capped[3] += prep["k_pad"]
    out.append(("B7 capped", xyc, capped, n))
    return out, prep


def segment_pairs(seed: int):
    """(window, read, guide) pairs for the decode modes' backward
    segments of 8 diagonals: m + n = 320 - d for d = 0..15 (every residue
    mod 16; the odd ones end at kq - 1), two reads shorter than a segment
    (m + n = 6 and 5) and one of m + n = 1,392."""
    from nanopore_tpu_torch.io.sam import CIG

    rng = np.random.default_rng(seed)
    pairs = []
    for L, d in [(160, d) for d in range(16)] + [(3, 0), (3, 1), (700, 8)]:
        x = rng.integers(0, 4, L).astype(np.int8)
        cut = L // 2
        y = np.concatenate([x[:cut], x[cut + d:]])
        sub = rng.random(len(y)) < 0.10
        y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
        guide = [(CIG.M, len(y))] + ([(CIG.D, d)] if d else [])
        pairs.append((x, y, guide))
    return pairs


def bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (NaN patterns included)."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def nan_equal(a, b) -> bool:
    """Two float tensors equal bit for bit where neither is NaN, and NaN
    in the same places (whatever the NaN's payload)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return a.shape == b.shape and torch.equal(na, nb) and bits_equal(
        torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def mea_segments_check(dev, params, cfg) -> None:
    """The decode modes' segment hazards on the card: decode and decode
    + gamma at W = 64 and 32 on :func:`segment_pairs`, and again with
    the long read's m raised past k_pad (a capped read): every output
    bit-identical to the plain version's."""
    from nanopore_tpu_torch.ops.realign import (
        realign_decode,
        realign_decode_plain,
    )

    t0 = time.perf_counter()
    for W_ in (W, W_REALIGN):
        xyc, m, n, prep = device_batch(segment_pairs(SEED + W_), W_, None,
                                       dev, "segment batch W=%d" % W_)
        k_pad = prep["k_pad"]
        capped = m.clone()
        capped[-1] += k_pad
        kend = (m.long() + n.long()).cpu().numpy()
        if sorted(set(kend[:16] % 16)) != list(range(16)) or kend.min() >= 8:
            fail("the segment batch misses a residue or a short read")
        for what, mm in (("", m), (" capped", capped)):
            for gam in (False, True):
                args = (xyc, mm, n, params, cfg.gap_gamma, cfg.match_gamma)
                out_k = realign_decode(*args, emit_gamma=gam)
                out_p = realign_decode_plain(*args, emit_gamma=gam)
                differ = [key for key in out_p
                          if not bits_equal(out_k[key], out_p[key])]
                name = "decode + gamma" if gam else "decode"
                print("K2 %s segment batch%s W=%d (B=%d, m + n %d..%d, k_pad "
                      "%d): %s" % (name, what, W_, len(kend),
                                   int((mm.long() + n.long()).min()),
                                   int((mm.long() + n.long()).max()), k_pad,
                                   "bit-identical" if not differ
                                   else "DIFFERENT in %s" % differ))
                if differ:
                    fail("%s differs from its plain version on the segment "
                         "batch%s W=%d" % (name, what, W_))
    print("K2 decode segment batches: %.1f s wall" % (time.perf_counter() - t0))


def pack_random_bytes_check(dev) -> None:
    """The pack kernel on streams of random bytes (every d1 pattern and
    symbols and top bits the host never sends) at W = 64 and 32, k_pad
    over three chunks and part of a fourth: byte-identical."""
    import torch

    from nanopore_tpu_torch.ops.pack import pack_xyc, pack_xyc_plain

    rng = np.random.default_rng(SEED + 3)
    for W_ in (W, W_REALIGN):
        B, k_pad = 8, 800
        stream = rng.integers(0, 256, (B, k_pad)).astype(np.uint8)
        stream[1] &= 0xBF  # never shifts
        stream[2] |= 0x40  # always shifts
        args = [torch.from_numpy(a).to(dev) for a in (
            stream, rng.integers(0, 256, (B, W_)).astype(np.uint8),
            np.array([40, 300, k_pad + 50, 0, 7, 400, 2000, 3], np.int32),
            np.array([90, k_pad + 9, 60, 5, 0, 400, 10, 1], np.int32))]
        if not torch.equal(pack_xyc(*args), pack_xyc_plain(*args)):
            fail("pack kernel differs from its plain version on random "
                 "bytes at W=%d" % W_)
        print("K1 pack on random bytes: B=%d k_pad=%d W=%d byte-identical"
              % (B, k_pad, W_))


def mea_walk_ragged(dev, params, cfg) -> None:
    """The MEA walker kernel against its plain version on the ragged
    batches at W = 64 and 32, on the realign kernel's direction codes
    and on random ones (paths that leave the band): bit for bit."""
    import torch

    from nanopore_tpu_torch.ops.realign import realign_decode
    from nanopore_tpu_torch.ops.traceback import mea_walk, mea_walk_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for W_ in (W, W_REALIGN):
        batches, prep = ragged_batches(dev, W_)
        for name, xyc, m, n in batches:
            kend = (m.long() + n.long()).clamp_max(prep["k_pad"])
            mc = m.clamp_max(prep["k_pad"])
            out = realign_decode(xyc, mc, n, params, cfg.gap_gamma,
                                 cfg.match_gamma)
            if "capped" in name:
                # the caller's kend with the capped read's m + n above
                # k_pad: the launch plan takes it, the kernel clamps the
                # read's diagonals to k_pad, and nothing changes
                host = (mc.long() + n.long()).cpu().numpy()
                if host.max() <= prep["k_pad"]:
                    fail("the capped ragged batch has no kend above k_pad")
                out2 = realign_decode(xyc, mc, n, params, cfg.gap_gamma,
                                      cfg.match_gamma, kend=host)
                if not all(torch.equal(a.view(torch.int8), b.view(torch.int8))
                           for a, b in ((out[k], out2[k]) for k in
                                        ("loglik", "score", "dirs"))):
                    fail("realign decode with a kend above k_pad differs "
                         "from the launch without it")
                print("K2 realign ragged %s W=%d: kend %s (k_pad %d) gives "
                      "the outputs of the launch without it, bit for bit"
                      % (name, W_, host.tolist(), prep["k_pad"]))
            dirs = out["dirs"]
            rand = torch.randint(0, 4, dirs.shape, generator=gen, device=dev,
                                 dtype=torch.int8)
            codes = [("realign codes", dirs), ("random codes", rand)]
            for what, d in codes[:1 if name.startswith("B1") else 2]:
                ops_k = mea_walk(d, xyc, m, n)
                ops_p = mea_walk_plain(d, xyc, m, n)
                if not torch.equal(ops_k, ops_p):
                    fail("MEA walker kernel differs from its plain version "
                         "on the ragged batch %s W=%d (%s)" % (name, W_, what))
            print("K3 walker ragged %s W=%d (m + n %s, k_pad %d): ops "
                  "identical on realign%s codes"
                  % (name, W_, kend.tolist(), prep["k_pad"],
                     "" if name.startswith("B1") else " and random"))


def viterbi_walk_ragged(dev, params) -> None:
    """The Viterbi walker kernel against its plain version on the ragged
    batches at W = 64 and 32, on the Viterbi kernel's plane (every walk
    but the capped read's reaches the origin) and on a random plane
    (walks that end short of it): op codes and end cells bit for bit."""
    import torch

    from nanopore_tpu_torch.ops.traceback import (
        viterbi_walk,
        viterbi_walk_plain,
    )
    from nanopore_tpu_torch.ops.viterbi import viterbi_forward

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for W_ in (W, W_REALIGN):
        batches, prep = ragged_batches(dev, W_)
        for name, xyc, m, n in batches:
            out = viterbi_forward(xyc, m.clamp_max(prep["k_pad"]), n, params)
            rand = torch.randint(0, 80, out["bp"].shape, generator=gen,
                                 device=dev, dtype=torch.int8)
            rstate = torch.randint(0, 5, out["fstate"].shape, generator=gen,
                                   device=dev, dtype=torch.int32)
            lost = {}
            for what, bp, fs in (("Viterbi plane", out["bp"], out["fstate"]),
                                 ("random plane", rand, rstate)):
                ops_k, end_k = viterbi_walk(bp, xyc, m, n, fs)
                ops_p, end_p = viterbi_walk_plain(bp, xyc, m, n, fs)
                if not (torch.equal(ops_k, ops_p)
                        and torch.equal(end_k, end_p)):
                    fail("Viterbi walker kernel differs from its plain "
                         "version on the ragged batch %s W=%d (%s)"
                         % (name, W_, what))
                lost[what] = int(end_k.any(1).sum())
            print("K5 viterbi walker ragged %s W=%d (k_pad %d): ops and end "
                  "cells identical; walks short of the origin %s"
                  % (name, W_, prep["k_pad"], lost))
            capped = "capped" in name
            if lost["Viterbi plane"] != int(capped):
                fail("Viterbi walks on the ragged batch %s: %d lost"
                     % (name, lost["Viterbi plane"]))


def ragged_plain(name, plain, want, args):
    """The plain version's outputs for the ragged batch ``name``: a
    one-read batch takes its read's rows of the B = 7 batch's outputs
    (``want``, filled as the batches come; a read's plain outputs do not
    depend on its batch), any other runs ``plain(*args)``."""
    if name in RAGGED_B1_ROWS:
        r = RAGGED_B1_ROWS[name]
        return {k: v[r:r + 1] for k, v in want["B7"].items()}
    want[name] = plain(*args)
    return want[name]


def edited_params(params, entries):
    """``params`` with the transitions ``entries`` ((src, dest, value)
    triples) set, their rows renormalised: gap entries at 0 keep the
    canonical structure, a positive entry from one gap state to another
    leaves it."""
    from nanopore_tpu_torch.ops.pairhmm import params_from_numpy

    t = params.t.detach().cpu().double().numpy().reshape(5, 5).copy()
    for src, dest, value in entries:
        t[src, dest] = value
        t[src] /= t[src].sum()
    return params_from_numpy(t, params.e_match_flat.cpu().numpy(),
                             params.e_gap_flat.cpu().numpy())


def viterbi_ragged_check(dev, params) -> None:
    """The Viterbi kernel on the ragged batches: score, fstate and the
    whole backpointer plane bit-identical to the plain version's under
    ``params`` (its short step) at W = 64 and 32; at W = 64 under
    ``params`` with gap state 2's self-transition at 0 (still the short
    step: its match entry is positive); and at W = 64 and 32 with gap
    state 2 entered from nowhere (t[0 -> 2] = t[2 -> 2] = 0: the 5-way
    step).  On that last model the short step, launched by hand on the
    B = 7 batch, is shown to differ from the plain version."""
    from nanopore_tpu_torch.ops import viterbi as V

    t0 = time.perf_counter()
    models = (("short step", params, (W, W_REALIGN)),
              ("short step, t[2->2] = 0",
               edited_params(params, [(2, 2, 0.0)]), (W,)),
              ("5-way step, t[0->2] = t[2->2] = 0",
               edited_params(params, [(0, 2, 0.0), (2, 2, 0.0)]),
               (W, W_REALIGN)))
    for what, p, _ in models:
        if V.short_step(V.viterbi_tables(p)) != what.startswith("short"):
            fail("the Viterbi wrapper would not take the %s" % what)
    for W_ in (W, W_REALIGN):
        batches, prep = ragged_batches(dev, W_)
        for what, p, widths in models:
            if W_ not in widths:
                continue
            want, names = {}, []
            for name, xyc, m, n in batches:
                out_k = V.viterbi_forward(xyc, m, n, p)
                out_p = ragged_plain(name, V.viterbi_forward_plain, want,
                                     (xyc, m, n, p))
                differ = [key for key in out_p
                          if not bits_equal(out_k[key], out_p[key])]
                if differ:
                    fail("Viterbi kernel (%s) differs from its plain version "
                         "on the ragged batch %s W=%d in %s"
                         % (what, name, W_, differ))
                names.append(name)
            print("K4 viterbi ragged W=%d (k_pad %d), %s: score, fstate and "
                  "the whole plane bit-identical on %s"
                  % (W_, prep["k_pad"], what, ", ".join(names)))
            if what.startswith("5-way"):
                _, xyc, m, n = batches[0]
                forced = V._launch(xyc, m, n, V.viterbi_tables(p), True)
                cells = int((forced["bp"] != want["B7"]["bp"]).sum())
                print("K4 viterbi ragged B7 W=%d, %s: the short step, "
                      "launched by hand, differs from the plain version in "
                      "%d plane bytes" % (W_, what, cells))
    print("K4 viterbi ragged batches: %.1f s wall" % (time.perf_counter() - t0))


N_RUNS = ((400, 120, 150), (380, 60, 200), (420, 200, 120), (300, 100, 40),
          (360, 0, 0))
# runs of N long enough for a band of 256 (length, start, run length)
N_RUNS_WIDER = ((600, 150, 250), (560, 100, 300), (640, 200, 220),
                (500, 120, 200), (520, 0, 0))
# and for a band of 512
N_RUNS_WIDEST = ((1200, 300, 500), (1120, 200, 520), (1000, 240, 460),
                 (1100, 300, 540), (1040, 0, 0))
# and for a band of 1024 (four reads switch mid-read)
N_RUNS_W1024 = ((2400, 600, 1000), (2240, 400, 1040), (2000, 480, 920),
                (2200, 600, 1080), (2080, 0, 0))


def n_run_case(params, runs=N_RUNS, e_n: float = 1e-40):
    """Pairs whose reads hold a run of N bases (the last read none)
    against an N-free reference, and ``params`` with every emission of
    an N at ``e_n``: once the band's last cell before the run leaves it,
    the band maximum falls by ~e_n within a pair of diagonals, to a
    subnormal.  At 1e-40 its inverse overflows and the loglik turns NaN
    (so tests/test_torch_forward.py's N-run case, at the kernel's
    widths); at 1e-37, on :data:`N_RUNS_WIDER` in 256 lanes and
    :data:`N_RUNS_WIDEST` in 512, the maximum's inverse stays finite, and
    so does the loglik."""
    from nanopore_tpu_torch.io.sam import CIG
    from nanopore_tpu_torch.ops.pairhmm import params_from_numpy

    rng = np.random.default_rng(SEED)
    pairs = []
    for L, p0, ln in runs:
        x = rng.integers(0, 4, L).astype(np.int8)
        y = x.copy()
        y[p0:p0 + ln] = 4
        pairs.append((x, y, [(CIG.M, L)]))
    em = params.e_match_flat.cpu().numpy().reshape(5, 5).copy()
    eg = params.e_gap_flat.cpu().numpy().reshape(5, 5).copy()
    em[:, 4] = em[4, :] = eg[:, 4] = np.float32(e_n)
    return pairs, params_from_numpy(params.t.cpu().numpy(), em.reshape(-1),
                                    eg.reshape(-1))


def forward_ragged_check(dev, params) -> None:
    """The forward-only kernel's reciprocal against ``__frcp_rn`` on
    every positive float.  Then the kernel on the ragged batches and the
    segment batches at W = 64 and 32, under ``params`` (its two-term gap
    sum), under ``params`` with t[0 -> 2] = t[2 -> 2] = 0 (still the
    canonical structure: the two-term sum) and with t[1 -> 2] > 0 (the
    5-way sum): the wrapper must pick that sum, the loglik must be the
    plain version's bit for bit, and no read may leave the two-term sum.
    On the last model the two-term sum, launched by hand on the B = 7
    batch, is shown to differ.  Then the N-run reads of
    :func:`n_run_case` at both widths: bit for bit, every N-run read
    sent to the 5-way sum mid-read, the N-free read not."""
    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables

    t0 = time.perf_counter()
    bad = F.reciprocal_mismatches(dev)
    print("K6 forward: the kernel's reciprocal of the band maximum differs "
          "from __frcp_rn on %d of the 2.1e9 positive floats (%.1f s)"
          % (bad, time.perf_counter() - t0))
    if bad:
        fail("the forward kernel's call-free reciprocal is not __frcp_rn")
    models = (("two-term sum", params, True),
              ("two-term sum, t[0->2] = t[2->2] = 0",
               edited_params(params, [(0, 2, 0.0), (2, 2, 0.0)]), True),
              ("5-way sum, t[1->2] = 0.05",
               edited_params(params, [(1, 2, 0.05)]), False))
    for what, p, two in models:
        if F.two_term_sum(kernel_tables(p)) != two:
            fail("the forward wrapper would not take the %s" % what)

    def plain(xyc, m, n, p):
        return {"loglik": F.forward_loglik_plain(xyc, m, n, p)}

    for W_ in (W, W_REALIGN):
        batches, prep = ragged_batches(dev, W_)
        xyc, m, n, _ = device_batch(segment_pairs(SEED + W_), W_, None, dev,
                                    "segment batch", check_pack=False)
        batches.append(("segments", xyc, m, n))
        for what, p, two in models:
            want, names = {}, []
            for name, xyc, m, n in batches:
                ll = F.forward_loglik(xyc, m, n, p)
                switched = F._launch(xyc, m, n, kernel_tables(p),
                                     two)["switched"]
                out_p = ragged_plain(name, plain, want, (xyc, m, n, p))
                if not bits_equal(ll, out_p["loglik"]):
                    fail("forward kernel (%s) differs from its plain version "
                         "on the batch %s W=%d" % (what, name, W_))
                if bool((switched != -1).any()):
                    fail("forward kernel (%s) left the two-term sum on the "
                         "batch %s W=%d" % (what, name, W_))
                names.append(name)
            print("K6 forward W=%d (ragged k_pad %d), %s: loglik bit-identical "
                  "on %s" % (W_, prep["k_pad"], what, ", ".join(names)))
            if not two:
                _, xyc, m, n = batches[0]
                forced = F._launch(xyc, m, n, kernel_tables(p), True)
                print("K6 forward B7 W=%d, %s: the two-term sum, launched by "
                      "hand, differs from the plain version on %d of 7 reads"
                      % (W_, what, int((forced["loglik"]
                                        != want["B7"]["loglik"]).sum())))
        forward_n_run_check(dev, params, W_)
    print("K6 forward ragged, segment and N-run batches: %.1f s wall"
          % (time.perf_counter() - t0))


def forward_n_run_check(dev, params, W_: int) -> None:
    """The forward-only kernel on the N-run reads of :func:`n_run_case`
    in W_ lanes: the loglik bit for bit the plain version's, every N-run
    read sent to the 5-way sum mid-read, the N-free read not."""
    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables

    pairs, p = n_run_case(params)
    xyc, m, n, _ = device_batch(pairs, W_, None, dev, "N-run batch",
                                check_pack=False)
    ll = F.forward_loglik(xyc, m, n, p)
    switched = F._launch(xyc, m, n, kernel_tables(p), True)["switched"]
    want = F.forward_loglik_plain(xyc, m, n, p)
    kend = (m + n).long()
    mid = ((switched > 1) & (switched < kend)).tolist()
    print("K6 forward N-run batch W=%d: loglik %s (plain %s), first 5-way "
          "diagonal %s of m + n %s" % (W_, ll.tolist(), want.tolist(),
                                       switched.tolist(), kend.tolist()))
    if not bits_equal(ll, want):
        fail("forward kernel differs from its plain version on the N-run "
             "batch W=%d" % W_)
    if mid != [True] * (len(pairs) - 1) + [False] or switched[-1] != -1:
        fail("the N-run reads did not switch to the 5-way sum mid-read "
             "at W=%d" % W_)


def gamma_ragged_check(dev, params) -> None:
    """The gamma mode on the ragged batches and the segment batches at
    W = 64 and 32: loglik and the whole gamma band bit-identical to the
    plain version's."""
    from nanopore_tpu_torch.ops.realign import (
        realign_gamma,
        realign_gamma_plain,
    )

    t0 = time.perf_counter()
    for W_ in (W, W_REALIGN):
        batches, prep = ragged_batches(dev, W_)
        xyc, m, n, _ = device_batch(segment_pairs(SEED + W_), W_, None, dev,
                                    "segment batch", check_pack=False)
        batches.append(("segments", xyc, m, n))
        want = {}
        for name, xyc, m, n in batches:
            out_k = realign_gamma(xyc, m, n, params)
            out_p = ragged_plain(name, realign_gamma_plain, want,
                                 (xyc, m, n, params))
            differ = [key for key in out_p
                      if not bits_equal(out_k[key], out_p[key])]
            kend = (m.long() + n.long())
            print("K2-gamma %s W=%d (B=%d, m + n %d..%d, k_pad %d): %s"
                  % (name, W_, len(kend), int(kend.min()), int(kend.max()),
                     xyc.shape[1], "bit-identical" if not differ
                     else "DIFFERENT in %s" % differ))
            if differ:
                fail("gamma mode differs from its plain version on the %s "
                     "batch W=%d" % (name, W_))
    print("K2-gamma ragged and segment batches: %.1f s wall"
          % (time.perf_counter() - t0))


def kend_guard_child() -> int:
    """Run as ``chip_smoke.py --kend-guard`` in a child process: a
    realign launch with the caller's kend equal to m + n passes, one
    with kend below m + n must fail at the next synchronise (the
    kernel's trap on the device leaves the context unusable, hence the
    child).  Prints KEND_GUARD_FIRED when it did."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
    from nanopore_tpu_torch.ops.realign import realign_decode

    dev = torch.device("cuda", 0)
    xyc, m, n, prep = device_batch(ragged_pairs(SEED), W, None, dev,
                                   "kend guard batch", check_pack=False)
    params = make_kernel_params(PairHmmModel.default())
    kend = prep["m"].astype(np.int64) + prep["n"]
    good = realign_decode(xyc, m, n, params, kend=kend)
    torch.cuda.synchronize()
    print("kend = m + n: loglik finite %s"
          % bool(torch.isfinite(good["loglik"]).all()), flush=True)
    try:
        realign_decode(xyc, m, n, params, kend=kend // 2)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print("kend = (m + n) / 2: %s" % str(exc).splitlines()[0])
        print("KEND_GUARD_FIRED", flush=True)
        return 0
    print("kend = (m + n) / 2: no error", flush=True)
    return 1


def kend_guard_check() -> None:
    """ROADMAP C8 on the card: the realign kernel refuses a read whose
    m + n needs more workspace than the caller's kend gave it."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--kend-guard"],
        capture_output=True, text=True, timeout=600)
    out = proc.stdout.strip().splitlines()
    for line in out:
        print("kend guard child: " + line)
    if proc.returncode != 0 or "KEND_GUARD_FIRED" not in out:
        sys.stdout.write(proc.stderr[-3000:])
        fail("a kend below m + n did not fail on the card")
    print("kend guard: a kend below m + n failed at the next synchronise "
          "(%.1f s wall, child process)" % (time.perf_counter() - t0))


def kernel_phase(engine, fq: str, dev) -> dict:
    """Step 3: the kernel rows of the mapping main path."""
    import torch

    from nanopore_tpu_torch.ops import pack, realign, traceback
    from nanopore_tpu_torch.ops.dispatch import (
        _pairs_k_max,
        preferred_realign_batch_size,
    )
    from nanopore_tpu_torch.ops.pack import (
        pack_stream_pairs,
        pack_xyc,
        pack_xyc_plain,
    )
    from nanopore_tpu_torch.ops.realign import (
        realign_decode,
        realign_decode_plain,
    )
    from nanopore_tpu_torch.ops.traceback import (
        mea_walk,
        mea_walk_plain,
        rle_ops_batch,
    )

    B = preferred_realign_batch_size(None, dev)
    pairs = main_path_batch(engine, fq, B)
    if len(pairs) != B:
        fail("only %d candidates for a batch of %d" % (len(pairs), B))
    prep = pack_stream_pairs(pairs, W, _pairs_k_max(pairs, None))
    k_pad = prep["k_pad"]
    print("main-path batch: B=%d K=%d k_pad=%d W=%d" % (B, prep["K"], k_pad, W))
    if k_pad < 2048:
        fail("k_pad %d below 2048" % k_pad)

    def put(a):
        return torch.from_numpy(a).to(dev)

    m, n = put(prep["m"]), put(prep["n"])
    stream, initx = put(prep["stream"]), put(prep["initx"])
    need_diags = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    params = engine.params
    cfg = engine.config
    res = {}

    # ---- K1 pack ----
    xyc = pack_xyc(stream, initx, m, n)
    t0 = time.perf_counter()
    xyc_p, plain_ms = timed(lambda: pack_xyc_plain(stream, initx, m, n))
    if not torch.equal(xyc, xyc_p):
        fail("pack kernel differs from its plain version")
    pack_err = float((xyc.int() - xyc_p.int()).abs().max())
    ms = cuda_ms(lambda: pack_xyc(stream, initx, m, n), 20)
    nbytes = B * k_pad + B * W + 8 * B + B * k_pad * W
    res["pack"] = dict(
        per_batch=launches_per_call(
            pack.LAUNCHES, lambda: pack_xyc(stream, initx, m, n)),
        ms=ms, plain_ms=plain_ms, max_abs_err=pack_err,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    del xyc_p
    print("K1 pack: byte-identical; %.4f ms (plain %.1f ms, %.1f s wall)"
          % (ms, plain_ms, time.perf_counter() - t0))
    pack_random_bytes_check(dev)

    # ---- K2 realign ----
    t0 = time.perf_counter()
    out_k = realign_decode(xyc, m, n, params, cfg.gap_gamma, cfg.match_gamma)
    out_p, plain_ms = timed(lambda: realign_decode_plain(
        xyc, m, n, params, cfg.gap_gamma, cfg.match_gamma))
    for key in ("loglik", "score"):
        if not bool(torch.isfinite(out_k[key]).all()):
            fail("non-finite realign %s" % key)
    ll_rel = float(((out_k["loglik"] - out_p["loglik"]).abs()
                    / out_p["loglik"].abs()).max())
    sc_rel = float(((out_k["score"] - out_p["score"]).abs()
                    / out_p["score"].abs().clamp_min(1e-30)).max())
    err = float(torch.maximum(
        (out_k["loglik"] - out_p["loglik"]).abs().max(),
        (out_k["score"] - out_p["score"]).abs().max()))
    dirs_rows = int((out_k["dirs"] != out_p["dirs"]).flatten(1).any(1).sum())
    ops_k = mea_walk(out_k["dirs"], xyc, m, n)
    cig_k = rle_ops_batch(ops_k.cpu().numpy())
    cig_p = rle_ops_batch(mea_walk(out_p["dirs"], xyc, m, n).cpu().numpy())
    cig_diff = sum(a != b for a, b in zip(cig_k, cig_p))
    print("K2 realign: loglik max rel %.3g, score max rel %.3g, reads with "
          "differing dirs %d, with differing cigars %d of %d (%.1f s wall)"
          % (ll_rel, sc_rel, dirs_rows, cig_diff, B,
             time.perf_counter() - t0))
    if ll_rel > 1e-5 or sc_rel > 1e-4:
        fail("realign kernel outside tolerance")
    if cig_diff > 0.01 * B:
        fail("%d reads' cigars differ (> 1%%)" % cig_diff)
    ms = cuda_ms(lambda: realign_decode(xyc, m, n, params, cfg.gap_gamma,
                                        cfg.match_gamma, kend=prep["k_end"]),
                 3)
    bound, by = realign_bound(
        REALIGN_OPS_PER_CELL, W, need_diags,
        B * k_pad * W + B * (k_pad + 1) * W + 8 * B + 8 * B)
    res["realign"] = dict(
        per_batch=launches_per_call(realign.LAUNCHES, lambda: realign_decode(
            xyc, m, n, params, cfg.gap_gamma, cfg.match_gamma)),
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound_ms=bound, bound_by=by,
    )
    del out_p
    print("K2 realign: %.3f ms per batch (plain %.1f ms)" % (ms, plain_ms))
    if res["realign"]["per_batch"] != 1:
        fail("the mapping batch's decode took %d launches, not 1"
             % res["realign"]["per_batch"])

    # ---- K3 walker ----
    dirs = out_k["dirs"]
    t0 = time.perf_counter()
    ops_p, plain_ms = timed(lambda: mea_walk_plain(dirs, xyc, m, n))
    if not torch.equal(ops_k, ops_p):
        fail("walker kernel differs from its plain version")
    walk_err = float((ops_k.int() - ops_p.int()).abs().max())
    ms = cuda_ms(lambda: mea_walk(dirs, xyc, m, n), 10)
    # a direction byte per step of the walks (their ops other than 3), a
    # code byte per diagonal of each read, an op byte per diagonal of
    # the batch, m and n
    nbytes = walked_bytes(ops_k) + need_diags - B + B * (k_pad + 1) + 8 * B
    res["traceback"] = dict(
        per_batch=launches_per_call(
            traceback.LAUNCHES, lambda: mea_walk(dirs, xyc, m, n)),
        ms=ms, plain_ms=plain_ms, max_abs_err=walk_err,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    print("K3 walker: ops identical; %.3f ms (plain %.1f ms, %.1f s wall)"
          % (ms, plain_ms, time.perf_counter() - t0))
    t0 = time.perf_counter()
    mea_walk_ragged(dev, params, cfg)
    print("K3 walker ragged batches: %.1f s wall" % (time.perf_counter() - t0))
    mea_segments_check(dev, params, cfg)
    for name, r in res.items():
        print("%s: %.4f ms per batch, %d launch(es) per batch, bound %.4f ms "
              "(%s), plain %.1f ms, library_ms null (no single PyTorch call)"
              % (name, r["ms"], r["per_batch"], r["bound_ms"], r["bound_by"],
                 r["plain_ms"]))
    return res


def walked_bytes(ops) -> int:
    """The direction or backpointer bytes a walk reads: one per step, so
    one per op other than 3 (none), which a skipped diagonal and the
    rows past a read's end get."""
    return int((ops != 3).sum())


def realign_bound(ops_per_cell: int, W_: int, need_diags: int,
                  nbytes: int) -> tuple:
    """(bound ms, what bounds it) of a realign launch."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_cell * W_ * need_diags / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def chained_pairs(chained_sam: str, fa: str, pad: int):
    """(window, read, guide) of every chained record, windowed at ``pad``
    as the EM (256) and realign (128) stages window them."""
    from nanopore_tpu_torch.align.realign import window_global_pair
    from nanopore_tpu_torch.io.encoding import encode
    from nanopore_tpu_torch.io.sam import SamReader
    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    ref = {k: encode(v) for k, v in read_fasta_dict(fa).items()}
    pairs = []
    for rec in SamReader(chained_sam).mapped():
        xw, guide, _, _ = window_global_pair(ref[rec.rname], rec.cigar, pad)
        pairs.append((xw, encode(rec.seq), guide))
    return pairs


def device_batch(pairs, W_: int, k_max, dev, what: str,
                 check_pack: bool = True):
    """Pack a batch as ``prepared_from_pairs`` does, and (``check_pack``)
    hold the pack kernel against its plain version at this shape:
    (xyc, m, n, prep)."""
    import torch

    from nanopore_tpu_torch.ops.dispatch import _pairs_k_max
    from nanopore_tpu_torch.ops.pack import (
        pack_stream_pairs,
        pack_xyc,
        pack_xyc_plain,
    )

    prep = pack_stream_pairs(pairs, W_, _pairs_k_max(pairs, k_max))
    m = torch.from_numpy(prep["m"]).to(dev)
    n = torch.from_numpy(prep["n"]).to(dev)
    stream = torch.from_numpy(prep["stream"]).to(dev)
    initx = torch.from_numpy(prep["initx"]).to(dev)
    xyc = pack_xyc(stream, initx, m, n)
    if not check_pack:
        return xyc, m, n, prep
    xyc_p, plain_ms = timed(lambda: pack_xyc_plain(stream, initx, m, n))
    if not torch.equal(xyc, xyc_p):
        fail("pack kernel differs from its plain version on the %s" % what)
    print("K1 pack on the %s: B=%d k_pad=%d W=%d byte-identical (plain "
          "%.1f ms)" % (what, len(pairs), prep["k_pad"], W_, plain_ms))
    return xyc, m, n, prep


def shape_buckets(pairs) -> dict:
    """Indices of ``pairs`` by padded window shape (n_pad, m_pad), as the
    realign stage and the analyses bucket them."""
    from nanopore_tpu_torch.align.realign import _next_pow2

    buckets = {}
    for i, pair in enumerate(pairs):
        buckets.setdefault(
            (_next_pow2(len(pair[0])), _next_pow2(len(pair[1]))), []
        ).append(i)
    return buckets


def fullest_bucket(pairs):
    """The pairs of the fullest bucket of window shapes, its diagonal
    count and every bucket's size."""
    buckets = shape_buckets(pairs)
    (n_pad, m_pad), best = max(buckets.items(), key=lambda kv: len(kv[1]))
    return ([pairs[i] for i in best], n_pad + m_pad,
            {k: len(v) for k, v in buckets.items()})


def em_kernel_phase(chained_sam: str, fa: str, dev, res: dict) -> None:
    """The EM path's kernel rows, each kernel against its plain version
    on the path's own batches: pack on both batches, EM mode at W = 64,
    decode mode and walker at W = 32."""
    import torch

    from nanopore_tpu_torch.align.em import representable
    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.ops import forward, realign
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size
    from nanopore_tpu_torch.ops.forward import (
        forward_loglik,
        forward_loglik_plain,
    )
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables, make_kernel_params
    from nanopore_tpu_torch.ops.realign import (
        realign_decode,
        realign_decode_plain,
        realign_em,
        realign_em_plain,
    )
    from nanopore_tpu_torch.ops.traceback import (
        mea_walk,
        mea_walk_plain,
        rle_ops_batch,
    )

    B = preferred_realign_batch_size(None, dev)
    P = PLAIN_READS
    # the model of an EM iteration: a random restart, as em_train draws it
    params = make_kernel_params(
        PairHmmModel.random(np.random.default_rng(SEED)))

    # ---- K2-em: realign kernel, EM mode, W = 64, EM windows ----
    t0 = time.perf_counter()
    pairs = chained_pairs(chained_sam, fa, 256)[:B]
    if len(pairs) != B:
        fail("only %d chained reads for an EM batch of %d" % (len(pairs), B))
    xyc, m, n, prep = device_batch(pairs, W, None, dev, "EM batch")
    k_pad = prep["k_pad"]
    print("EM batch: B=%d K=%d k_pad=%d W=%d" % (B, prep["K"], k_pad, W))
    out_k = realign_em(xyc, m, n, params)
    out_p, plain_ms = timed(lambda: realign_em_plain(
        xyc[:P].contiguous(), m[:P].contiguous(), n[:P].contiguous(), params))
    # a window that reaches the end of the reference (a chained record
    # ending <tail>D <k>I) can leave the f32 range under this model:
    # em_train leaves such a read out; here kernel and plain version must
    # agree on which entries are finite, and on the finite ones
    held = representable(
        out_k["trans"].double().cpu().numpy(),
        out_k["emis"].double().cpu().numpy(), prep["m"], prep["n"])
    if not bool(torch.isfinite(out_k["loglik"]).all()):
        fail("non-finite EM loglik")
    if held.sum() < 0.9 * B:
        fail("only %d of %d reads' EM sums are representable"
             % (held.sum(), B))
    ll_rel = float(((out_k["loglik"][:P] - out_p["loglik"]).abs()
                    / out_p["loglik"].abs()).max())
    rels, err = {}, 0.0
    for key in ("trans", "emis"):
        a, b = out_k[key][:P].flatten(1), out_p[key].flatten(1)
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            fail("EM kernel and plain version differ in which %s entries "
                 "are finite" % key)
        ok = torch.from_numpy(held[:P]).to(dev)
        a, b = a[ok], b[ok]
        rels[key] = float(((a - b).abs().amax(1) / b.abs().amax(1)).max())
        err = max(err, float((a - b).abs().max()))
    print("K2-em: loglik max rel %.3g, trans max rel %.3g, emis max rel %.3g "
          "(per read, to the table's largest entry; %d reads, %d of them "
          "representable; %d of the batch's %d representable; %.1f s wall)"
          % (ll_rel, rels["trans"], rels["emis"], P, held[:P].sum(),
             held.sum(), B, time.perf_counter() - t0))
    if ll_rel > 1e-5 or max(rels.values()) > 3e-5:
        fail("EM kernel outside tolerance")
    ms = cuda_ms(lambda: realign_em(xyc, m, n, params, kend=prep["k_end"]),
                 3)
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    bound, by = realign_bound(REALIGN_EM_OPS_PER_CELL, W, need,
                              B * k_pad * W + 8 * B + B * 106 * 4)
    res["realign_em"] = dict(
        per_batch=launches_per_call(
            realign.EM_LAUNCHES, lambda: realign_em(xyc, m, n, params)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, max_abs_err=err,
        bound_ms=bound, bound_by=by,
    )
    print("K2-em: %.3f ms per batch of %d in %d launch(es) (plain %.1f ms "
          "on %d reads)" % (ms, B, res["realign_em"]["per_batch"], plain_ms,
                            P))
    print("K2-em: launches per E-step %d" % res["realign_em"]["per_batch"])
    if res["realign_em"]["per_batch"] != 1:
        fail("the EM batch took %d launches, not 1"
             % res["realign_em"]["per_batch"])
    # a read's sums do not depend on its batch's diagonal count: the
    # short reads re-packed without the far-end windows, kernel against
    # kernel, bit for bit (NaN patterns included)
    kend = prep["m"].astype(np.int64) + prep["n"]
    short = np.nonzero(4 * kend <= k_pad)[0]
    if len(short) < 0.9 * B:
        fail("only %d of %d EM reads are short" % (len(short), B))
    xs, ms_, ns, ps = device_batch([pairs[i] for i in short], W, None, dev,
                                   "EM short reads", check_pack=False)
    out_s = realign_em(xs, ms_, ns, params)
    sel = torch.from_numpy(short).to(dev)
    differ = [key for key in ("loglik", "trans", "emis")
              if not torch.equal(out_k[key][sel].view(torch.int32),
                                 out_s[key].view(torch.int32))]
    print("K2-em: the %d short reads (m + n <= k_pad / 4) re-packed without "
          "the other %d at k_pad %d: sums %s to the full batch's"
          % (len(short), B - len(short), ps["k_pad"],
             "bit-identical" if not differ else "DIFFERENT in %s" % differ))
    if differ:
        fail("EM sums of the short reads depend on the batch's k_pad")
    # the plan's other branch: under a quarter of the workspace cap the
    # batch takes several launches, with the same sums
    cap, box = realign.WORKSPACE_BYTES, []
    realign.WORKSPACE_BYTES = cap // 4
    try:
        n_split = launches_per_call(realign.EM_LAUNCHES, lambda: box.append(
            realign_em(xyc, m, n, params, kend=prep["k_end"])))
    finally:
        realign.WORKSPACE_BYTES = cap
    differ = [key for key in ("loglik", "trans", "emis")
              if not torch.equal(out_k[key].view(torch.int32),
                                 box[0][key].view(torch.int32))]
    print("K2-em: under a quarter of the workspace cap, %d launches: sums %s"
          % (n_split, "bit-identical" if not differ
             else "DIFFERENT in %s" % differ))
    if n_split < 2 or differ:
        fail("the EM batch split over launches differs")
    # K6 on the EM batch (its two-term sum under this model), held on the
    # far-end windows, where the band leaves the path (ROADMAP C6)
    t0 = time.perf_counter()
    far = torch.from_numpy(np.nonzero(4 * kend > k_pad)[0]).to(dev)
    ll_k = forward_loglik(xyc, m, n, params)
    switched = forward._launch(xyc, m, n, kernel_tables(params), True)[
        "switched"]
    ll_p = forward_loglik_plain(xyc[far].contiguous(), m[far].contiguous(),
                                n[far].contiguous(), params)
    print("K6 forward on the EM batch: loglik of its %d far-end windows (m + "
          "n %s) %s to the plain version's; reads sent to the 5-way sum %d of "
          "%d (%.1f s wall)"
          % (len(far), kend[far.cpu().numpy()].tolist(),
             "bit-identical" if bits_equal(ll_k[far], ll_p) else "DIFFERENT",
             int((switched != -1).sum()), B, time.perf_counter() - t0))
    if not bits_equal(ll_k[far], ll_p):
        fail("forward kernel differs from its plain version on the EM "
             "batch's far-end windows")
    del xyc, out_k, out_p, xs, out_s, box

    # ---- K1, K2 decode and K3 at W = 32: the realign stage's fullest
    # bucket of window shapes (windows of pad 128) ----
    t0 = time.perf_counter()
    pairs, k_max, sizes = fullest_bucket(chained_pairs(chained_sam, fa, 128))
    pairs = pairs[:B]
    Br = len(pairs)
    print("realign buckets: %s" % sizes)
    if Br < P:
        fail("the fullest realign bucket holds only %d reads" % Br)
    xyc, m, n, prep = device_batch(pairs, W_REALIGN, k_max, dev,
                                   "realign batch")
    k_pad = prep["k_pad"]
    print("realign batch: B=%d K=%d k_pad=%d W=%d"
          % (Br, prep["K"], k_pad, W_REALIGN))
    dflt = make_kernel_params(PairHmmModel.default())
    out_k = realign_decode(xyc, m, n, dflt)
    xs, ms_, ns = (t[:P].contiguous() for t in (xyc, m, n))
    out_p, plain_ms = timed(lambda: realign_decode_plain(xs, ms_, ns, dflt))
    ll_rel = float(((out_k["loglik"][:P] - out_p["loglik"]).abs()
                    / out_p["loglik"].abs()).max())
    sc_rel = float(((out_k["score"][:P] - out_p["score"]).abs()
                    / out_p["score"].abs().clamp_min(1e-30)).max())
    err = float(torch.maximum(
        (out_k["loglik"][:P] - out_p["loglik"]).abs().max(),
        (out_k["score"][:P] - out_p["score"]).abs().max()))
    # the walker at this shape, on the whole bucket: kernel against plain
    # on the kernel's direction codes; the plain realign's codes go
    # through the plain walker, so its cigars owe nothing to either kernel
    dirs_k = out_k["dirs"]
    ops_k = mea_walk(dirs_k, xyc, m, n)
    ops_kp, walk_plain_ms = timed(lambda: mea_walk_plain(dirs_k, xyc, m, n))
    if not torch.equal(ops_k, ops_kp):
        fail("walker kernel differs from its plain version at W=32")
    walk_ms = cuda_ms(lambda: mea_walk(dirs_k, xyc, m, n), 10)
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    res["traceback"].update(
        ms_w32=walk_ms, plain_ms_w32=walk_plain_ms, reads_w32=Br,
        bound_ms_w32=(walked_bytes(ops_k) + need - Br + Br * (k_pad + 1)
                      + 8 * Br) / HBM_BYTES_PER_S * 1e3)
    ops_k = ops_k[:P]
    cig_k = rle_ops_batch(ops_k.cpu().numpy())
    cig_p = rle_ops_batch(
        mea_walk_plain(out_p["dirs"], xs, ms_, ns).cpu().numpy())
    cig_diff = sum(a != b for a, b in zip(cig_k, cig_p))
    print("K3 walker W=32: ops identical on the bucket's %d reads; %.3f ms "
          "per batch, bound %.4f ms (bytes), plain %.1f ms"
          % (Br, walk_ms, res["traceback"]["bound_ms_w32"], walk_plain_ms))
    print("K2 realign W=32: loglik max rel %.3g, score max rel %.3g, reads "
          "with differing cigars %d of %d (%.1f s wall)"
          % (ll_rel, sc_rel, cig_diff, P, time.perf_counter() - t0))
    if ll_rel > 1e-5 or sc_rel > 1e-4:
        fail("realign kernel at W=32 outside tolerance")
    if cig_diff > 0.01 * P:
        fail("%d reads' cigars differ at W=32 (> 1%%)" % cig_diff)
    ms = cuda_ms(lambda: realign_decode(xyc, m, n, dflt, kend=prep["k_end"]),
                 3)
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    bound, by = realign_bound(
        REALIGN_OPS_PER_CELL, W_REALIGN, need,
        Br * k_pad * W_REALIGN + Br * (k_pad + 1) * W_REALIGN + 16 * Br)
    res["realign"].update(
        ms_w32=ms, plain_ms_w32=plain_ms, plain_reads_w32=P, reads_w32=Br,
        max_abs_err_w32=err, bound_ms_w32=bound, bound_by_w32=by,
    )
    print("K2 realign W=32: %.3f ms per batch of %d, bound %.4f ms (%s), "
          "plain %.1f ms on %d reads" % (ms, Br, bound, by, plain_ms, P))


def check_em_outputs(sam: str, hmm: str, ref_len: int) -> dict:
    """The EM path's products: traces, model and global records."""
    import xml.etree.ElementTree as ET

    from nanopore_tpu_torch.align.model import PairHmmModel

    traces = [[float(v) for v in el.attrib["runningLikelihoods"].split()]
              for el in ET.parse(hmm + ".xml").getroot().iter("hmm")]
    if len(traces) != 2:
        fail("expected 2 EM trials, found %d" % len(traces))
    for t, trace in enumerate(traces):
        if not trace or not np.isfinite(trace).all():
            fail("trial %d: bad running likelihoods %s" % (t, trace))
        for a, b in zip(trace[1:], trace[2:]):
            if b < a - 1e-6 * abs(a):
                fail("trial %d: likelihood fell from %r to %r" % (t, a, b))
    for path in (hmm, hmm + "_unnormalised"):
        model = PairHmmModel.load(path)
        for table in (model.transitions, model.emissions):
            if not np.isfinite(table).all() or not np.allclose(
                    table.sum(axis=1), 1.0, atol=1e-6):
                fail("%s: rows do not sum to 1" % path)
    return dict(check_global_records(sam, ref_len),
                iterations=[len(t) for t in traces],
                final_loglik=[t[-1] for t in traces])


def check_global_records(sam: str, ref_len: int) -> dict:
    """Every record global (pos 0, cigar consuming the whole reference
    and read): the count of reads and the share at their origin."""
    from nanopore_tpu_torch.io.sam import CIG, SamReader

    names, hits = set(), 0
    for rec in SamReader(sam).mapped():
        names.add(rec.qname)
        ref_used = sum(ln for op, ln in rec.cigar if op in (CIG.M, CIG.D))
        read_used = sum(ln for op, ln in rec.cigar if op in (CIG.M, CIG.I))
        if rec.pos != 0 or ref_used != ref_len or read_used != len(rec.seq):
            fail("%s is not a global record" % rec.qname)
        _, start, strand = rec.qname[1:].split("_")
        lead = rec.cigar[0][1] if rec.cigar[0][0] == CIG.D else 0
        if bool(rec.flag & 0x10) == bool(int(strand)) and abs(
                lead - int(start)) <= 100:
            hits += 1
    return {"records": len(names), "origin_share": hits / N_READS}


def em_path_phase(workdir: str, dev, counters, res: dict) -> dict:
    """Kernel rows and end-to-end run of the EM path; returns the warm
    run's launch counts."""
    import torch

    from nanopore_tpu_torch.align.chain_sam import chain_sam_file
    from nanopore_tpu_torch.align.em import EmOptions
    from nanopore_tpu_torch.mapping.runner import run_mapper

    # ---- the EM path: its kernel rows on its own data ----
    em_dir = os.path.join(workdir, "em")
    fa2, fq2 = write_workload(em_dir, EM_REF_LEN)
    mapped = os.path.join(em_dir, "mapped.sam")
    chained = os.path.join(em_dir, "chained.sam")
    run_mapper("LastParams", fq2, "reads", fa2, mapped, device=dev)
    chain_sam_file(mapped, chained, fq2, fa2)
    em_kernel_phase(chained, fa2, dev, res)

    # ---- the EM path end to end: cold run, then the warm one ----
    em_sam = os.path.join(em_dir, "out.sam")
    hmm = os.path.join(em_dir, "hmm.txt")
    em_opts = EmOptions(trials=2, iterations=10)
    run_mapper("LastParamsRealignEm", fq2, "reads", fa2, em_sam,
               hmm_file_to_train=hmm, em_options=em_opts, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    warm_em = run_mapper("LastParamsRealignEm", fq2, "reads", fa2, em_sam,
                         hmm_file_to_train=hmm, em_options=em_opts,
                         device=dev)
    torch.cuda.synchronize()
    em_wall = time.perf_counter() - t0
    em_launches = {c.name: c.count for c in counters}
    em_peak = torch.cuda.max_memory_allocated(dev)
    snap = warm_em.stage_stats.snapshot()
    checks = check_em_outputs(em_sam, hmm, EM_REF_LEN)
    its = snap["em_e_step"]["calls"]
    print("EM path: %d reads in %.3f s warm: map %.3f s, chain %.3f s, EM "
          "%.3f s, realign %.3f s; peak device memory %.3f GB; launches %s"
          % (N_READS, em_wall, snap["wall"]["seconds"],
             snap["post_chain"]["seconds"], snap["post_em"]["seconds"],
             snap["post_realign"]["seconds"], em_peak / 1e9, em_launches))
    print("EM path: %d iterations (per trial %s); E-step %.3f ms on the "
          "device in %.2f launch(es) and %.4f s on the host clock per "
          "iteration, flank correction %.4f s per iteration, M-step %.6f s "
          "per iteration; final logliks %s"
          % (its, checks["iterations"],
             snap["em_e_step_device"]["seconds"] / its * 1e3,
             em_launches["realign_em"] / its,
             snap["em_e_step"]["seconds"] / its,
             snap["em_flank"]["seconds"] / its,
             snap["em_m_step"]["seconds"] / its, checks["final_loglik"]))
    print("EM path: %d global records, %.4f of reads at their origin; reads "
          "left out of the EM counts, summed over the iterations: %d"
          % (checks["records"], checks["origin_share"],
             snap.get("em_left_out", {"calls": 0})["calls"]))
    print("stage_stats_em " + json.dumps(snap))
    if min(em_launches[k] for k in ("pack", "realign", "realign_em",
                                    "traceback")) <= 0:
        fail("a kernel of the EM path was not launched: %s" % em_launches)
    if checks["records"] != N_READS:
        fail("%d records for %d reads" % (checks["records"], N_READS))
    if checks["origin_share"] < 0.99:
        fail("only %.4f of realigned reads at their origin"
             % checks["origin_share"])
    return em_launches


def finite_err(out_k: dict, out_p: dict, keys, P: int, what: str) -> float:
    """Largest difference of kernel and plain outputs over their first
    ``P`` reads, on the entries finite in both; the two must agree on
    which entries are finite."""
    import torch

    err = 0.0
    for key in keys:
        a, b = out_k[key][:P].float(), out_p[key].float()
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            fail("%s: kernel and plain version differ in which %s entries "
                 "are finite" % (what, key))
        if bool(fa.any()):
            err = max(err, float((a - b)[fa].abs().max()))
    return err


def rel_err(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def posterior_kernel_phase(fq: str, local_sam: str, global_sam: str,
                           fa: str, dev, res: dict) -> dict:
    """The posterior path's kernel rows on its own batches: the gamma
    mode at W = 64 (AlignmentUncertainty), the decode + gamma mode at
    W = 32 (rescore), the exp mode at W = 64 (SNP caller), its far-end
    buckets included.  Returns, for the SNP caller's first plain-checked
    records, {record index: (window start, (n, 4) expectations)} from
    the plain version under the default model."""
    import torch

    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.analyses.alignment_uncertainty import (
        trained_hmm_path,
    )
    from nanopore_tpu_torch.analyses.common import ExperimentData
    from nanopore_tpu_torch.io.encoding import encode
    from nanopore_tpu_torch.io.sam import CIG
    from nanopore_tpu_torch.ops import realign
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size
    from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
    from nanopore_tpu_torch.ops.posteriors import posterior_expectations_fused
    from nanopore_tpu_torch.ops.realign import (
        realign_decode,
        realign_decode_plain,
        realign_exp,
        realign_exp_plain,
        realign_gamma,
        realign_gamma_plain,
    )
    from nanopore_tpu_torch.align.realign import window_global_pair

    B = preferred_realign_batch_size(None, dev)
    P = POST_PLAIN_READS

    def guide_of(rec):
        return [(op, ln) for op, ln in rec.cigar
                if op in (CIG.M, CIG.I, CIG.D)]

    # ---- K2-gamma: AlignmentUncertainty's fullest batch, W = 64 ----
    t0 = time.perf_counter()
    data = ExperimentData(fq, fa, local_sam)
    items = [(data.ref_codes[rec.rname][rec.pos:rec.aend], encode(rec.query),
              guide_of(rec)) for rec in data.records]
    pairs, k_max, sizes = fullest_bucket(items)
    pairs = pairs[:B]
    print("uncertainty buckets: %s" % sizes)
    if len(pairs) < P:
        fail("the fullest uncertainty bucket holds only %d reads" % len(pairs))
    xyc, m, n, prep = device_batch(pairs, W, k_max, dev, "uncertainty batch")
    Bu, k_pad = len(pairs), prep["k_pad"]
    params0 = make_kernel_params(
        PairHmmModel.load(trained_hmm_path("blasr_hmm_0.txt")))
    xs, ms_, ns = (t[:P].contiguous() for t in (xyc, m, n))
    out_k = realign_gamma(xyc, m, n, params0)
    out_p, plain_ms = timed(lambda: realign_gamma_plain(xs, ms_, ns, params0))
    err = finite_err(out_k, out_p, ("gamma", "loglik"), P, "K2-gamma")
    same = torch.equal(out_k["gamma"][:P], out_p["gamma"])
    ll_rel = rel_err(out_k["loglik"][:P], out_p["loglik"])
    print("K2-gamma W=64: B=%d k_pad=%d; gamma max abs err %.3g (%s), loglik "
          "max rel %.3g on %d reads (%.1f s wall)"
          % (Bu, k_pad, err, "bit-identical" if same else "not identical",
             ll_rel, P, time.perf_counter() - t0))
    if err > 5e-5 or ll_rel > 1e-5:
        fail("gamma mode outside tolerance")
    ms = cuda_ms(lambda: realign_gamma(xyc, m, n, params0,
                                       kend=prep["k_end"]), 3)
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    bound, by = realign_bound(REALIGN_GAMMA_OPS_PER_CELL, W, need,
                              Bu * k_pad * W + Bu * (k_pad + 1) * W * 4
                              + 12 * Bu)
    res["realign_gamma"] = dict(
        per_batch=launches_per_call(realign.GAMMA_LAUNCHES,
                                    lambda: realign_gamma(xyc, m, n, params0)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, reads=Bu, k_pad=k_pad,
        max_abs_err=err, bound_ms=bound, bound_by=by,
    )
    print("K2-gamma W=64: %.3f ms per batch of %d, bound %.4f ms (%s), plain "
          "%.1f ms on %d reads" % (ms, Bu, bound, by, plain_ms, P))
    del xyc, out_k, out_p
    gamma_ragged_check(dev, params0)

    # ---- K2 decode + gamma: the rescore's fullest batch, W = 32 ----
    t0 = time.perf_counter()
    pairs, k_max, sizes = fullest_bucket(chained_pairs(global_sam, fa, 128))
    pairs = pairs[:B]
    print("rescore buckets: %s" % sizes)
    xyc, m, n, prep = device_batch(pairs, W_REALIGN, k_max, dev,
                                   "rescore batch")
    Br, k_pad = len(pairs), prep["k_pad"]
    dflt = make_kernel_params(PairHmmModel.default())
    xs, ms_, ns = (t[:P].contiguous() for t in (xyc, m, n))
    out_k = realign_decode(xyc, m, n, dflt, emit_gamma=True)
    out_p, plain_ms = timed(lambda: realign_decode_plain(
        xs, ms_, ns, dflt, emit_gamma=True))
    err = finite_err(out_k, out_p, ("gamma", "loglik", "score"), P,
                     "K2 decode + gamma")
    same = torch.equal(out_k["gamma"][:P], out_p["gamma"])
    ll_rel = rel_err(out_k["loglik"][:P], out_p["loglik"])
    sc_rel = rel_err(out_k["score"][:P], out_p["score"])
    dirs_rows = int((out_k["dirs"][:P] != out_p["dirs"]).flatten(1).any(1)
                    .sum())
    print("K2 decode + gamma W=32: B=%d k_pad=%d; gamma max abs err %.3g "
          "(%s), loglik max rel %.3g, score max rel %.3g, reads with "
          "differing dirs %d of %d (%.1f s wall)"
          % (Br, k_pad, err, "bit-identical" if same else "not identical",
             ll_rel, sc_rel, dirs_rows, P, time.perf_counter() - t0))
    if err > 5e-5 or ll_rel > 1e-5 or sc_rel > 1e-4 or dirs_rows > 0.01 * P:
        fail("decode + gamma mode outside tolerance")
    ms = cuda_ms(lambda: realign_decode(xyc, m, n, dflt, emit_gamma=True,
                                        kend=prep["k_end"]), 3)
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    bound, by = realign_bound(
        REALIGN_OPS_PER_CELL, W_REALIGN, need,
        Br * k_pad * W_REALIGN + Br * (k_pad + 1) * W_REALIGN * 5 + 16 * Br)
    res["realign_decode_gamma"] = dict(
        per_batch=launches_per_call(
            realign.DECODE_GAMMA_LAUNCHES,
            lambda: realign_decode(xyc, m, n, dflt, emit_gamma=True)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, reads=Br, k_pad=k_pad,
        max_abs_err=err, bound_ms=bound, bound_by=by,
    )
    print("K2 decode + gamma W=32: %.3f ms per batch of %d, bound %.4f ms "
          "(%s), plain %.1f ms on %d reads" % (ms, Br, bound, by, plain_ms, P))
    del xyc, out_k, out_p

    # ---- K2-exp: the SNP caller's fullest batch, W = 64 ----
    t0 = time.perf_counter()
    data = ExperimentData(fq, fa, global_sam)
    items, starts = [], []
    for rec in data.records:
        xw, guide, j0, _ = window_global_pair(data.ref_codes[rec.rname],
                                              guide_of(rec))
        items.append((xw, encode(rec.query), guide))
        starts.append(j0)
    buckets = shape_buckets(items)
    print("SNP caller buckets: %s"
          % {k: len(v) for k, v in buckets.items()})
    main_key = max(buckets, key=lambda k: len(buckets[k]))
    sel = buckets[main_key][:B]
    pairs = [items[i] for i in sel]
    xyc, m, n, prep = device_batch(pairs, W, sum(main_key), dev,
                                   "SNP caller batch")
    Bs, k_pad = len(pairs), prep["k_pad"]
    xs, ms_, ns = (t[:P].contiguous() for t in (xyc, m, n))
    out_k = realign_exp(xyc, m, n, dflt, SNP_THRESHOLD)
    out_p, plain_ms = timed(lambda: realign_exp_plain(
        xs, ms_, ns, dflt, SNP_THRESHOLD))
    err = finite_err(out_k, out_p, ("ret", "flush", "loglik"), P, "K2-exp")
    same = all(torch.equal(out_k[k][:P], out_p[k]) for k in ("ret", "flush"))
    ll_rel = rel_err(out_k["loglik"][:P], out_p["loglik"])
    print("K2-exp W=64: B=%d k_pad=%d; retire rows and flush max abs err "
          "%.3g (%s), loglik max rel %.3g on %d reads (%.1f s wall)"
          % (Bs, k_pad, err, "bit-identical" if same else "not identical",
             ll_rel, P, time.perf_counter() - t0))
    if err > 5e-5 or ll_rel > 1e-5:
        fail("exp mode outside tolerance")
    ms = cuda_ms(lambda: realign_exp(xyc, m, n, dflt, SNP_THRESHOLD,
                                     kend=prep["k_end"]), 3)
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    bound, by = realign_bound(
        REALIGN_EXP_OPS_PER_CELL, W, need,
        Bs * k_pad * W + Bs * (k_pad + 1) * 16 + Bs * 4 * W * 4 + 12 * Bs)
    res["realign_exp"] = dict(
        per_batch=launches_per_call(realign.EXP_LAUNCHES, lambda: realign_exp(
            xyc, m, n, dflt, SNP_THRESHOLD)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, reads=Bs, k_pad=k_pad,
        max_abs_err=err, bound_ms=bound, bound_by=by,
    )
    print("K2-exp W=64: %.3f ms per batch of %d, bound %.4f ms (%s), plain "
          "%.1f ms on %d reads" % (ms, Bs, bound, by, plain_ms, P))
    # what the SNP caller's card route must return for these records
    # under the default model: the plain streams, pulled and scattered
    # into reference coordinates on the host
    exps = posterior_expectations_fused(
        out_p["ret"].cpu(), out_p["flush"].cpu(), prep["offsets"][:P],
        prep["n"][:P], W)
    glue_want = {sel[b]: (starts[sel[b]], e) for b, e in enumerate(exps)}
    del xyc, out_k, out_p

    # ---- K2-exp on the far-end windows (ROADMAP C6): every other bucket
    # timed at the shape the SNP caller launches it, the longest held
    # against the plain version on up to 3 of its reads (and the pack
    # kernel on all of them) ----
    far_ms = {}
    longest = max(buckets, key=sum)
    for key in sorted(buckets, key=sum):
        if key == main_key:
            continue
        lp = [items[i] for i in buckets[key][:B]]
        xl, ml, nl, pl = device_batch(lp, W, sum(key), dev,
                                      "SNP caller bucket %s" % (key,),
                                      check_pack=key == longest)
        far_ms["%dx%d" % key] = cuda_ms(
            lambda: realign_exp(xl, ml, nl, dflt, SNP_THRESHOLD,
                                kend=pl["k_end"]), 3)
        print("K2-exp W=64 bucket %s: %d reads at k_pad %d, %.3f ms per "
              "launch" % (key, len(lp), pl["k_pad"], far_ms["%dx%d" % key]))
        if key == longest:
            kept = (lp, xl, ml, nl, pl)
    res["realign_exp"]["far_end_ms"] = far_ms
    res["realign_exp"]["far_end_ms_total"] = sum(far_ms.values())
    if longest != main_key:
        t0 = time.perf_counter()
        lp, xl, ml, nl, pl = kept
        P3 = min(3, len(lp))
        out_k = realign_exp(xl, ml, nl, dflt, SNP_THRESHOLD)
        out_p = realign_exp_plain(*(t[:P3].contiguous() for t in (xl, ml, nl)),
                                  dflt, SNP_THRESHOLD)
        err = finite_err(out_k, out_p, ("ret", "flush", "loglik"), P3,
                         "K2-exp on the longest windows")
        same = all(torch.equal(out_k[k][:P3], out_p[k])
                   for k in ("ret", "flush"))
        nonfin = int((~torch.isfinite(out_k["ret"])).flatten(1).any(1).sum())
        print("K2-exp W=64 longest bucket %s: %d of its %d reads, windows "
              "%s, k_pad %d; retire rows and flush max abs err %.3g (%s), "
              "reads of the bucket with non-finite retire rows %d (%.1f s "
              "wall)" % (longest, P3, len(lp), [len(p[0]) for p in lp[:P3]],
                         pl["k_pad"], err,
                         "bit-identical" if same else "not identical",
                         nonfin, time.perf_counter() - t0))
        if err > 5e-5:
            fail("exp mode outside tolerance on the longest windows")
        res["realign_exp"]["max_abs_err_longest"] = err
        res["realign_exp"]["max_abs_err"] = max(
            res["realign_exp"]["max_abs_err"], err)
    return glue_want


def posterior_path_phase(workdir: str, dev, counters, res: dict) -> dict:
    """Kernel rows and the three posterior entry points on the second
    workload's reads over a mutated reference; returns each run's launch
    counts."""
    import shutil
    import xml.etree.ElementTree as ET

    import torch

    from nanopore_tpu_torch.align.realign import realign_records
    from nanopore_tpu_torch.analyses import (
        AlignmentUncertainty,
        MarginAlignSnpCaller,
    )
    from nanopore_tpu_torch.analyses.mutate_reference import (
        mutate_reference_sequences,
    )
    from nanopore_tpu_torch.analyses.snp_caller import HMM_TYPES
    from nanopore_tpu_torch.io.sam import SamReader
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.mapping.runner import run_mapper

    em_dir = os.path.join(workdir, "em")
    post_dir = os.path.join(workdir, "post")
    os.makedirs(post_dir, exist_ok=True)
    ref = os.path.join(post_dir, "ref.fa")
    shutil.copy(os.path.join(em_dir, "ref.fa"), ref)
    fq = os.path.join(em_dir, "reads.fq")
    _, mut_fa = mutate_reference_sequences([ref], rates=(MUTATION_RATE,),
                                           seed=SEED)
    local_sam = os.path.join(post_dir, "local.sam")
    global_sam = os.path.join(post_dir, "realigned.sam")
    t0 = time.perf_counter()
    run_mapper("LastParams", fq, "reads", mut_fa, local_sam, device=dev)
    run_mapper("LastParamsRealign", fq, "reads", mut_fa, global_sam,
               device=dev)
    print("posterior path inputs: %s, LastParams and LastParamsRealign "
          "SAMs in %.1f s" % (os.path.basename(mut_fa),
                              time.perf_counter() - t0))
    glue_want = posterior_kernel_phase(fq, local_sam, global_sam, mut_fa,
                                       dev, res)

    def drive(what, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.name: c.count for c in counters}
        print("%s: %.3f s; peak device memory %.3f GB; launches %s"
              % (what, wall, torch.cuda.max_memory_allocated(dev) / 1e9,
                 launches))
        return out, launches

    runs = {}
    # ---- AlignmentUncertainty on the local records ----
    au_dir = os.path.join(post_dir, "uncertainty")
    os.makedirs(au_dir, exist_ok=True)
    _, runs["uncertainty"] = drive("AlignmentUncertainty", lambda: (
        AlignmentUncertainty(fq, "reads", mut_fa, local_sam, au_dir,
                             device=dev).execute()))
    root = ET.parse(os.path.join(au_dir, "alignmentUncertainty.xml")).getroot()
    avg = float(root.attrib["averagePosteriorMatchProbability"])
    per_read = [float(v) for v in root.attrib[
        "averagePosteriorMatchProbabilitesPerRead"].split(",")]
    print("AlignmentUncertainty: %d records, weighted average posterior "
          "match probability %r, per-read mean %r, non-finite per-read "
          "averages %d" % (len(per_read), avg, float(np.nanmean(per_read)),
                           int((~np.isfinite(per_read)).sum())))
    if not (np.isfinite(avg) and 0.0 < avg <= 1.0):
        fail("AlignmentUncertainty: weighted average %r" % avg)

    # ---- the SNP caller on the realigned (global) records ----
    nonfinite, glue = {}, {}

    class Counting(MarginAlignSnpCaller):
        def _posteriors_for_hmm(self, data, model):
            out = super()._posteriors_for_hmm(data, model)
            i = len(nonfinite)
            nonfinite[i] = sum(not np.isfinite(e).all() for e in out)
            if HMM_TYPES[i] == "cactus":  # the default model
                glue["err"], glue["ok"] = glue_err(out, glue_want)
            return out

    snp_dir = os.path.join(post_dir, "snp")
    os.makedirs(snp_dir, exist_ok=True)
    _, runs["snp_caller"] = drive("MarginAlignSnpCaller", lambda: (
        Counting(fq, "reads", mut_fa, global_sam, snp_dir,
                 device=dev).execute()))
    nodes = list(ET.parse(os.path.join(
        snp_dir, "marginaliseConsensus.xml")).getroot())
    full = {nd.tag: float(nd.attrib["fScore"]) for nd in nodes
            if nd.attrib["coverage"] == "1000000"}
    print("MarginAlignSnpCaller: %d nodes, %s held out; full-coverage "
          "fScores %s; records with non-finite expectations per model %s; "
          "expectations of %d records under the default model against the "
          "plain version's, max abs err %.3g"
          % (len(nodes), nodes[0].attrib["totalHeldOut"] if nodes else "?",
             json.dumps(full, sort_keys=True),
             {HMM_TYPES[i]: c for i, c in nonfinite.items()},
             len(glue_want), glue["err"]))
    if len(nodes) != 208:
        fail("SNP caller wrote %d nodes, not 208" % len(nodes))
    # every call set over the posteriors (marginAlign*) must clear the
    # JAX test's bar on its own: the frequency call sets do not read them
    margin = [f for tag, f in full.items() if tag.startswith("marginAlign")]
    if len(full) != 16 or len(margin) != 8 or min(margin) <= 0.5:
        fail("SNP caller: full-coverage fScores %r" % full)
    if not glue["ok"]:
        fail("SNP caller's expectations differ from the plain version's")

    # ---- realign_records(rescore=True) on realigned records ----
    records = list(SamReader(global_sam).mapped())[:RESCORE_READS]
    ref_seqs = read_fasta_dict(mut_fa)
    scores, runs["rescore"] = drive(
        "realign_records(rescore=True)", lambda: realign_records(
            records, ref_seqs, band_width=W_REALIGN, rescore=True,
            device=dev))
    scores = np.asarray(scores)
    print("rescore: %d records, scores min %r mean %r max %r"
          % (len(scores), float(scores.min()), float(scores.mean()),
             float(scores.max())))
    if len(scores) != RESCORE_READS or not (
            np.isfinite(scores).all() and (scores >= 0).all()
            and (scores <= 1).all()):
        fail("rescore scores outside [0, 1] or non-finite")

    need = {"uncertainty": ("pack", "realign_gamma"),
            "snp_caller": ("pack", "realign_exp"),
            "rescore": ("pack", "realign_decode_gamma", "traceback")}
    for what, names in need.items():
        if min(runs[what][k] for k in names) <= 0:
            fail("a kernel of the %s path was not launched: %s"
                 % (what, runs[what]))
    return runs


def viterbi_kernel_phase(engine, pairs, dev, counters, res: dict) -> dict:
    """Phase 8: the Viterbi kernels on the mapping main path's batch.
    K4 and K6 against their plain versions on the first PLAIN_READS
    reads at the full diagonal count, K5 on K4's plane, K6 against the
    realign kernel's decode loglik and above the Viterbi score on the
    whole batch; each kernel timed on the whole batch.  Then K6 through
    its entry point (``PreparedForward``) with the counters set to 0
    just before; returns that run's launch counts."""
    import torch

    from nanopore_tpu_torch.ops import forward, traceback, viterbi
    from nanopore_tpu_torch.ops.dispatch import (
        PreparedForward,
        _pairs_k_max,
        prepared_from_pairs,
    )
    from nanopore_tpu_torch.ops.forward import (
        forward_loglik,
        forward_loglik_plain,
    )
    from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables
    from nanopore_tpu_torch.ops.realign import realign_decode
    from nanopore_tpu_torch.ops.traceback import (
        rle_ops_batch,
        viterbi_walk,
        viterbi_walk_plain,
    )
    from nanopore_tpu_torch.ops.viterbi import (
        short_step,
        viterbi_forward,
        viterbi_forward_plain,
        viterbi_tables,
    )

    t_phase = time.perf_counter()
    B = len(pairs)
    P = PLAIN_READS
    prep = pack_stream_pairs(pairs, W, _pairs_k_max(pairs, None))
    k_pad = prep["k_pad"]

    def put(a):
        return torch.from_numpy(a).to(dev)

    m, n = put(prep["m"]), put(prep["n"])
    xyc = pack_xyc(put(prep["stream"]), put(prep["initx"]), m, n)
    xs, ms_, ns = (t[:P].contiguous() for t in (xyc, m, n))
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    params = engine.params
    print("Viterbi batch: B=%d K=%d k_pad=%d W=%d" % (B, prep["K"], k_pad, W))

    # ---- K4 Viterbi ----
    t0 = time.perf_counter()
    out_k = viterbi_forward(xyc, m, n, params)
    out_p, plain_ms = timed(lambda: viterbi_forward_plain(xs, ms_, ns, params))
    sc_k, sc_p = out_k["score"][:P], out_p["score"]
    if not bool(torch.isfinite(out_k["score"]).all()):
        fail("non-finite Viterbi score")
    sc_rel = rel_err(sc_k, sc_p)
    err = float((sc_k - sc_p).abs().max())
    if not torch.equal(out_k["fstate"][:P], out_p["fstate"]):
        fail("Viterbi kernel's fstate differs from its plain version")
    # lattice cells of the checked reads: 1 <= k <= m + n, 0 <= i <= m,
    # 0 <= j <= n with j = o[k] + w
    K1 = k_pad + 1
    kk = torch.arange(K1, device=dev)[None, :, None]
    jj = put(prep["offsets"][:P].astype(np.int64))[:, :, None] + \
        torch.arange(W, device=dev)[None, None, :]
    ii = kk - jj
    lat = ((kk >= 1) & (jj >= 0) & (jj <= ns.long()[:, None, None])
           & (ii >= 0) & (ii <= ms_.long()[:, None, None]))
    bp_k = out_k["bp"][:P]
    lat_diff = int(((bp_k != out_p["bp"]) & lat).sum())
    whole = torch.equal(bp_k, out_p["bp"])
    del lat, ii, jj, kk
    print("K4 viterbi: score max rel %.3g (%s), fstate identical, plane cells "
          "differing on the lattice %d (whole plane %s) on %d reads (%.1f s "
          "wall)" % (sc_rel, "bit-identical" if torch.equal(sc_k, sc_p)
                     else "not identical", lat_diff,
                     "identical" if whole else "differs", P,
                     time.perf_counter() - t0))
    if sc_rel > 1e-5 or lat_diff:
        fail("Viterbi kernel outside tolerance")
    ms = cuda_ms(lambda: viterbi_forward(xyc, m, n, params), 3)
    bound, by = realign_bound(
        VITERBI_SHORT_OPS_PER_CELL if short_step(viterbi_tables(params))
        else VITERBI_OPS_PER_CELL, W, need,
        (need - B) * W + B * K1 * W + 12 * B)
    res["viterbi"] = dict(
        per_batch=launches_per_call(viterbi.LAUNCHES, lambda: viterbi_forward(
            xyc, m, n, params)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, max_abs_err=err,
        bound_ms=bound, bound_by=by,
    )
    print("K4 viterbi: %.3f ms per batch of %d, bound %.4f ms (%s), plain "
          "%.1f ms on %d reads" % (ms, B, bound, by, plain_ms, P))
    del out_p
    viterbi_ragged_check(dev, params)

    # ---- K5 Viterbi walker on K4's plane ----
    t0 = time.perf_counter()
    bp, fstate = out_k["bp"], out_k["fstate"]
    ops_k, end_k = viterbi_walk(bp, xyc, m, n, fstate)
    (ops_p, end_p), plain_ms = timed(lambda: viterbi_walk_plain(
        bp[:P].contiguous(), xs, ms_, ns, fstate[:P].contiguous()))
    if not (torch.equal(ops_k[:P], ops_p) and torch.equal(end_k[:P], end_p)):
        fail("Viterbi walker kernel differs from its plain version")
    walk_err = float((ops_k[:P].int() - ops_p.int()).abs().max())
    lost = int(end_k.any(1).sum())
    cigars = rle_ops_batch(ops_k.cpu().numpy())
    whole = 0
    for cig, mr, nr in zip(cigars, prep["m"], prep["n"]):
        whole += (sum(ln for op, ln in cig if op in (0, 1)) == mr
                  and sum(ln for op, ln in cig if op in (0, 2)) == nr)
    print("K5 viterbi walker: ops identical on %d reads; %d of %d walks reach "
          "the origin, %d cigars consume exactly m and n (%.1f s wall)"
          % (P, B - lost, B, whole, time.perf_counter() - t0))
    if lost or whole != B:
        fail("Viterbi walks: %d lost, %d of %d whole cigars" % (lost, whole, B))
    ms = cuda_ms(lambda: viterbi_walk(bp, xyc, m, n, fstate), 10)
    # a plane byte per step of the walks (their ops other than 3), a
    # code byte per diagonal of each read, an op byte per diagonal of
    # the batch, m, n, fstate and the end cell
    nbytes = walked_bytes(ops_k) + need - B + B * K1 + 20 * B
    res["viterbi_traceback"] = dict(
        per_batch=launches_per_call(traceback.VIT_LAUNCHES, lambda: viterbi_walk(
            bp, xyc, m, n, fstate)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, max_abs_err=walk_err,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    print("K5 viterbi walker: %.3f ms per batch (plain %.1f ms on %d reads)"
          % (ms, plain_ms, P))
    t0 = time.perf_counter()
    viterbi_walk_ragged(dev, params)
    print("K5 viterbi walker ragged batches: %.1f s wall"
          % (time.perf_counter() - t0))

    # ---- K6 forward only ----
    t0 = time.perf_counter()
    ll_k = forward_loglik(xyc, m, n, params)
    ll_p, plain_ms = timed(lambda: forward_loglik_plain(xs, ms_, ns, params))
    if not bool(torch.isfinite(ll_k).all()):
        fail("non-finite forward loglik")
    ll_rel = rel_err(ll_k[:P], ll_p)
    err = float((ll_k[:P] - ll_p).abs().max())
    dec = realign_decode(xyc, m, n, params, engine.config.gap_gamma,
                         engine.config.match_gamma)["loglik"]
    k2_rel = rel_err(ll_k, dec)
    vit = out_k["score"]
    above = int((vit > ll_k + 1e-5 * ll_k.abs()).sum())
    print("K6 forward: loglik max rel %.3g against its plain version on %d "
          "reads (%s), %.3g against the realign kernel's decode loglik on %d; "
          "reads whose Viterbi score is above the loglik %d; loglik - score "
          "mean %.4f nats (%.1f s wall)"
          % (ll_rel, P, "bit-identical" if torch.equal(ll_k[:P], ll_p)
             else "not identical", k2_rel, B, above,
             float((ll_k - vit).mean()), time.perf_counter() - t0))
    if ll_rel > 1e-5 or k2_rel > 1e-5 or above:
        fail("forward kernel outside tolerance")
    ms = cuda_ms(lambda: forward_loglik(xyc, m, n, params), 3)
    two = forward.two_term_sum(kernel_tables(params))
    # a code byte a diagonal of each read; m, n, the loglik and the
    # switch diagonal
    bound, by = realign_bound(
        FORWARD_SHORT_OPS_PER_CELL if two else FORWARD_OPS_PER_CELL, W,
        need, (need - B) * W + 16 * B)
    res["forward"] = dict(
        per_batch=launches_per_call(forward.LAUNCHES, lambda: forward_loglik(
            xyc, m, n, params)),
        ms=ms, plain_ms=plain_ms, plain_reads=P, max_abs_err=err,
        bound_ms=bound, bound_by=by, two_term=two,
    )
    print("K6 forward (%s sum): %.3f ms per batch of %d, bound %.4f ms (%s), "
          "plain %.1f ms on %d reads" % ("two-term" if two else "5-way", ms,
                                         B, bound, by, plain_ms, P))
    del out_k, bp, xyc
    forward_ragged_check(dev, params)

    # ---- K6 through its entry point ----
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    ll = prepared_from_pairs({"device": dev}, pairs, params, band_width=W,
                             prepared_cls=PreparedForward).run()
    torch.cuda.synchronize()
    entry = {c.name: c.count for c in counters}
    print("PreparedForward: %d reads in %.3f s; launches %s"
          % (len(pairs), time.perf_counter() - t0, entry))
    if not torch.equal(ll, ll_k) or entry["forward"] <= 0:
        fail("PreparedForward did not give the forward kernel's loglik")
    print("phase 8 wall: %.1f s" % (time.perf_counter() - t_phase))
    return entry


def viterbi_path_phase(workdir: str, fa: str, fq: str, dev, counters) -> dict:
    """Phase 9: ``run_mapper("Viterbi")`` on the mapping workload, cold
    then warm, and ``run_mapper("ViterbiRealign")`` once on the EM
    workload, each warm or single run with the counters set to 0 just
    before it; returns each run's launch counts."""
    import torch

    from nanopore_tpu_torch.mapping.runner import run_mapper

    t_phase = time.perf_counter()
    runs = {}
    sam = os.path.join(workdir, "viterbi.sam")
    run_mapper("Viterbi", fq, "reads", fa, sam, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    warm = run_mapper("Viterbi", fq, "reads", fa, sam, device=dev)
    wall = time.perf_counter() - t0
    runs["viterbi"] = {c.name: c.count for c in counters}
    share = origin_share(sam)
    print("Viterbi path: %d reads in %.3f s warm = %.1f reads/s; peak device "
          "memory %.3f GB; primaries at origin %.4f; launches %s"
          % (N_READS, wall, N_READS / wall,
             torch.cuda.max_memory_allocated(dev) / 1e9, share,
             runs["viterbi"]))
    print("stage_stats_viterbi " + json.dumps(warm.stage_stats.snapshot()))
    v = runs["viterbi"]
    if min(v[k] for k in ("pack", "viterbi", "viterbi_traceback")) <= 0:
        fail("a kernel of the Viterbi path was not launched: %s" % v)
    if v["realign"] or v["traceback"]:
        fail("the Viterbi path launched the MEA decode: %s" % v)
    if share < 0.99:
        fail("only %.4f of Viterbi primaries at their origin" % share)

    em_dir = os.path.join(workdir, "em")
    fa2, fq2 = os.path.join(em_dir, "ref.fa"), os.path.join(em_dir, "reads.fq")
    sam2 = os.path.join(em_dir, "viterbi_realign.sam")
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    eng = run_mapper("ViterbiRealign", fq2, "reads", fa2, sam2, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["viterbi_realign"] = {c.name: c.count for c in counters}
    checks = check_global_records(sam2, EM_REF_LEN)
    snap = eng.stage_stats.snapshot()
    print("ViterbiRealign: %d reads in %.3f s (one run: cold index) = map "
          "%.3f + chain and realign %.3f s; %d global records, %.4f at their "
          "origin; launches %s"
          % (N_READS, wall, snap["wall"]["seconds"],
             snap["post_realign"]["seconds"], checks["records"],
             checks["origin_share"], runs["viterbi_realign"]))
    r = runs["viterbi_realign"]
    if min(r[k] for k in ("pack", "viterbi", "viterbi_traceback", "realign",
                          "traceback")) <= 0:
        fail("a kernel of the ViterbiRealign path was not launched: %s" % r)
    if checks["records"] != N_READS or checks["origin_share"] < 0.99:
        fail("ViterbiRealign: %d records, %.4f at their origin"
             % (checks["records"], checks["origin_share"]))
    print("phase 9 wall: %.1f s" % (time.perf_counter() - t_phase))
    return runs


# phase 10: the pipeline's arguments (the EM depth is its one cut: 1 trial
# x 5 iterations against the reference's 3 x 100)
PIPELINE_ARGS = ["--max-threads", "4", "--em-trials", "1",
                 "--em-iterations", "5"]
# the five default meta-analyses, and two host ones beside them
EXTRA_META = ["CoverageDepth", "CustomTrackAssemblyHub"]
PIPELINE_ANALYSES = ["Hmm", "GlobalCoverage", "LocalCoverage",
                     "Substitutions", "Indels", "AlignmentUncertainty",
                     "ChannelMappability", "KmerAnalysis", "IndelKmerAnalysis"]
# the data files each default meta-analysis writes here (read type 2d,
# reads.fq, ref.fa; base mappers Blasr, Bwa, Last, Lastz), as the JAX
# package's classes write them
META_FILES = {
    "UnmappedKmerAnalysis": [
        "2d_unmapped_kmer_counts.txt", "2d_unmapped_pval_kmer_counts.txt",
        "2d_unmapped_top_bot_sigkmer_counts.txt"],
    "CoverageSummary": [
        "%s%s.csv" % (group, tail)
        for group in ["%s_%s" % (bm, what) for bm in ("Blasr", "Bwa", "Last",
                                                      "Lastz")
                      for what in ("2d_ref.fa", "reads.fq")] + ["ref.fa"]
        for tail in ("", "_distribution")],
    "UnmappedLengthDistributionAnalysis": [
        "2d_unmapped.txt", "2d_mapped.txt", "ref.fa_unmapped.txt",
        "ref.fa_mapped.txt"],
    "ComparePerReadMappabilityByMapper": ["2d_perReadMappability.tsv"],
    "HmmMetaAnalysis": [
        "hmm_2d.dot", "matchEmissionsNormalisedByReference_2d.tsv",
        "matchEmissionsUnnormalised_2d.tsv",
        "matchEmissionsUnnormalisedStdErrors_2d.tsv"],
    "CoverageDepth": [
        "experiment_reads.fq_ref.fa_%s%s" % (mapper, tail)
        for mapper in ("LastParamsChain", "BwaParamsRealignEm")
        for tail in ("_Depth.txt", "_Stats.out")],
    "CustomTrackAssemblyHub": [
        "hub_ref/hub.txt", "hub_ref/genomes.txt", "hub_ref/ref/ref.2bit",
        "hub_ref/ref/trackDb.txt",
        "hub_ref/ref/experiment_reads.fq_ref.fa_LastParamsChain.bam",
        "hub_ref/ref/experiment_reads.fq_ref.fa_LastParamsChain.bam.bai"],
}
# the workload's substitutions draw a random base, the read's own a
# quarter of the time: 10 % x 3/4 = 7.5 % of aligned read bases differ
# from the reference.  The MEA alignment may take a substitution as an
# insertion beside a deletion (the reads have deletions only), which
# lowers the share (6.4 % on 4 reads of 900 bases on the CPU), and may
# misplace a deletion, which raises it: the share is held to 5-9 %
SUBST_WINDOW = (0.05, 0.09)
AU_CPU_RECORDS = 2  # records of each LastParams* SAM that the CPU rescores


def data_files(d: str) -> dict:
    """{name: bytes} of an output directory's data files (no plots)."""
    return {
        f: open(os.path.join(d, f), "rb").read()
        for f in sorted(os.listdir(d)) if not f.endswith((".pdf", ".png"))
    }


def per_read_posteriors(xml_path: str) -> list:
    import xml.etree.ElementTree as ET

    a = ET.parse(xml_path).getroot().attrib
    return [float(v) for v in
            a["averagePosteriorMatchProbabilitesPerRead"].split(",") if v]


def pipeline_device_vs_cpu(out: str, fq: str, fa: str) -> None:
    """Substitutions and KmerAnalysis again on the CPU on each LastParams*
    experiment's SAM: byte-identical data files.  AlignmentUncertainty on
    the CPU on the first records of those SAMs, in one batch: each read's
    average posterior within 1e-4 of the pipeline's (the plain gamma on
    the CPU costs ~1 ms a diagonal, and a global record spans 73,728)."""
    import shutil

    from nanopore_tpu_torch.analyses import (
        AlignmentUncertainty,
        KmerAnalysis,
        Substitutions,
    )

    t0 = time.perf_counter()
    base = os.path.join(out, "analysis_2d")
    cpu_dir = os.path.join(os.path.dirname(out), "cpu")
    shutil.rmtree(cpu_dir, ignore_errors=True)
    subset = os.path.join(cpu_dir, "subset.sam")
    os.makedirs(cpu_dir)
    want_au = []
    with open(subset, "w") as sub:
        for i, mapper in enumerate(("LastParamsChain", "LastParamsRealign",
                                    "LastParamsRealignEm")):
            exp = os.path.join(base, "experiment_reads.fq_ref.fa_" + mapper)
            sam = os.path.join(exp, "mapping.sam")
            for cls in (Substitutions, KmerAnalysis):
                d = os.path.join(cpu_dir, mapper, cls.__name__)
                os.makedirs(d)
                cls(fq, "2d", fa, sam, d, device="cpu").execute()
                got = data_files(d)
                want = data_files(os.path.join(exp, "analysis_"
                                               + cls.__name__))
                if got != want or len(want) < 2:
                    fail("%s of %s: the card's data files differ from the "
                         "CPU's" % (cls.__name__, mapper))
            records = 0
            with open(sam) as fh:
                for line in fh:
                    if line.startswith("@"):
                        if i == 0:
                            sub.write(line)
                        continue
                    if int(line.split("\t", 2)[1]) & 4:
                        continue
                    if records == AU_CPU_RECORDS:
                        break
                    sub.write(line)
                    records += 1
            want_au += per_read_posteriors(os.path.join(
                exp, "analysis_AlignmentUncertainty",
                "alignmentUncertainty.xml"))[:AU_CPU_RECORDS]
    au_dir = os.path.join(cpu_dir, "AlignmentUncertainty")
    os.makedirs(au_dir)
    au = AlignmentUncertainty(fq, "2d", fa, subset, au_dir, device="cpu")
    au.batch_size = len(want_au)
    au.execute()
    got_au = per_read_posteriors(os.path.join(au_dir,
                                              "alignmentUncertainty.xml"))
    err = max(abs(a - b) for a, b in zip(got_au, want_au))
    print("pipeline, card against CPU: Substitutions and KmerAnalysis data "
          "files byte-identical on LastParamsChain, LastParamsRealign and "
          "LastParamsRealignEm; AlignmentUncertainty on %d records, "
          "largest difference of a read's average posterior %.3g (%.1f s "
          "wall)" % (len(got_au), err, time.perf_counter() - t0))
    if len(got_au) != len(want_au) or not err <= 1e-4:
        fail("AlignmentUncertainty: the CPU's %s, the card's %s"
             % (got_au, want_au))


def pipeline_phase(workdir: str, dev, counters) -> dict:
    """Phase 10: ``cli.main(["run", ...])`` with the default mappers,
    analyses and meta-analyses on the second workload, every counter set
    to 0 just before it; returns its launch counts."""
    import shutil
    import xml.etree.ElementTree as ET

    import torch

    from nanopore_tpu_torch import cli
    from nanopore_tpu_torch.mapping.presets import DEFAULT_MAPPERS
    from nanopore_tpu_torch.pipeline import DEFAULT_META_ANALYSES

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "pipeline")
    shutil.rmtree(root, ignore_errors=True)
    fa, fq = write_workload(os.path.join(root, "inputs"), EM_REF_LEN,
                            PIPELINE_READS)
    wd = os.path.join(root, "wd")
    for sub, src in (("readFastqFiles/2d", fq), ("referenceFastaFiles", fa)):
        os.makedirs(os.path.join(wd, sub))
        shutil.copy(src, os.path.join(wd, sub))
    metas = DEFAULT_META_ANALYSES + EXTRA_META
    argv = ["run", wd] + PIPELINE_ARGS + ["--meta-analyses", ",".join(metas)]
    print("pipeline: %s (%d mappers, %d analyses, %d meta-analyses on %d "
          "reads; the reads and the EM depth, 1 trial x 5 iterations, are "
          "the cuts)" % (" ".join(argv), len(DEFAULT_MAPPERS),
                         len(PIPELINE_ANALYSES), len(metas), PIPELINE_READS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        fail("the pipeline returned non-zero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    out = os.path.join(wd, "output")

    stats = json.load(open(os.path.join(out, "pipeline_stats.json")))
    bad = {k: (v["status"], v["attempts"]) for k, v in stats.items()
           if v["status"] != "done" or v["attempts"] != 1}
    want_tasks = len(DEFAULT_MAPPERS) * (1 + len(PIPELINE_ANALYSES)) + len(
        metas)
    if bad or len(stats) != want_tasks:
        fail("pipeline tasks not done on their first attempt: %s (%d tasks)"
             % (bad, len(stats)))
    kinds, by_analysis = {}, {}
    for name, v in stats.items():
        kind = name.split(":")[0]
        kinds[kind] = kinds.get(kind, 0.0) + v["wall_seconds"]
        if kind == "analysis":
            a = name.split(":")[1]
            by_analysis[a] = by_analysis.get(a, 0.0) + v["wall_seconds"]
    slowest = sorted(stats.items(), key=lambda kv: -kv[1]["wall_seconds"])[:5]
    print("pipeline: %d tasks in %.3f s; task seconds summed by kind %s; by "
          "analysis %s; peak device memory %.3f GB; launches %s"
          % (len(stats), wall, {k: round(v, 3) for k, v in kinds.items()},
             {k: round(v, 3) for k, v in sorted(
                 by_analysis.items(), key=lambda kv: -kv[1])},
             peak / 1e9, launches))
    for name, v in slowest:
        print("pipeline slowest: %.3f s %s" % (v["wall_seconds"],
                                               name.replace(out + "/", "")))

    base = os.path.join(out, "analysis_2d")
    posteriors = {}
    for mapper in DEFAULT_MAPPERS:
        exp = os.path.join(base, "experiment_reads.fq_ref.fa_" + mapper)
        if not os.path.exists(os.path.join(exp, "mapping.sam")):
            fail("%s wrote no mapping.sam" % mapper)
        for a in PIPELINE_ANALYSES:
            if not os.path.exists(os.path.join(exp, "analysis_" + a, "DONE")):
                fail("%s: analysis %s has no DONE" % (mapper, a))
        au = ET.parse(os.path.join(
            exp, "analysis_AlignmentUncertainty",
            "alignmentUncertainty.xml")).getroot().attrib
        p = float(au["averagePosteriorMatchProbability"])
        posteriors[mapper] = p
        if not (np.isfinite(p) and 0.0 < p <= 1.0):
            fail("%s: weighted average posterior %r" % (mapper, p))
    for meta in metas:
        d = os.path.join(out, "metaAnalysis_" + meta)
        missing = [f for f in META_FILES[meta]
                   if not os.path.exists(os.path.join(d, f))]
        if missing:
            fail("meta-analysis %s lacks %s" % (meta, missing))
    subst = ET.parse(os.path.join(
        base, "experiment_reads.fq_ref.fa_LastParamsChain",
        "analysis_Substitutions", "substitutions.xml")).getroot().attrib
    matches, mismatches = float(subst["matches"]), float(subst["mismatches"])
    share = mismatches / (matches + mismatches)
    print("pipeline: AlignmentUncertainty weighted average posterior per "
          "experiment %s; LastParamsChain substitution share over ACGT %.5f "
          "(window %s)" % ({k: round(v, 5) for k, v in posteriors.items()},
                           share, SUBST_WINDOW))
    if not SUBST_WINDOW[0] <= share <= SUBST_WINDOW[1]:
        fail("LastParamsChain substitution share %.5f" % share)
    on = ("pack", "realign", "traceback", "realign_em", "realign_gamma")
    off = ("realign_exp", "viterbi", "viterbi_traceback", "forward")
    if min(launches[k] for k in on) <= 0 or max(launches[k] for k in off):
        fail("pipeline launches %s: want %s > 0 and %s = 0"
             % (launches, on, off))
    pipeline_device_vs_cpu(
        out, os.path.join(out, "processedReadFastqFiles", "2d", "reads.fq"),
        os.path.join(out, "processedReferenceFastaFiles", "ref.fa"))
    print("phase 10 wall: %.1f s (the pipeline %.1f s)"
          % (time.perf_counter() - t_phase, wall))
    return launches


RESCUE_IDENTITY = 0.85  # the forward-strand reads' median Identity
RESCUE_CPU_JOBS = 2  # jobs held card against CPU (~7 s each on the CPU)


def rescue_phase(workdir: str, dev, counters) -> dict:
    """Phase 11: ``rescue_2d`` on the card, its 2D SAM a ``LastParams``
    mapping of phase 10's reads (the pipeline runs no plain
    ``LastParams`` experiment), every counter set to 0 just before it;
    returns its launch counts.  Then a few of its jobs on the card and
    on the CPU."""
    import shutil

    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.io.sam import SamReader, SamWriter
    from nanopore_tpu_torch.io.seqio import read_fasta_dict, read_fastq_dict
    from nanopore_tpu_torch.mapping.runner import run_mapper
    from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
    from nanopore_tpu_torch.scripts import rescue_2d

    t_phase = time.perf_counter()
    out = os.path.join(workdir, "pipeline", "wd", "output")
    fa = os.path.join(out, "processedReferenceFastaFiles", "ref.fa")
    fq = os.path.join(out, "processedReadFastqFiles", "2d", "reads.fq")
    wd = os.path.join(workdir, "rescue")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    twod = os.path.join(wd, "2d.sam")
    run_mapper("LastParams", fq, "2d", fa, twod, device=dev)
    os.makedirs(os.path.join(wd, "referenceFastaFiles"))
    shutil.copy(fa, os.path.join(wd, "referenceFastaFiles"))
    sams = []
    for read_type in ("template", "complement"):
        os.makedirs(os.path.join(wd, "readFastqFiles", read_type))
        shutil.copy(fq, os.path.join(wd, "readFastqFiles", read_type))
        sams.append(os.path.join(wd, read_type + ".sam"))
        SamWriter(sams[-1], template=SamReader(twod)).close()
    mapped = {r.qname: r for r in SamReader(twod).mapped()}
    out_dir = os.path.join(wd, "output")
    argv = sams + [twod, "--working-dir", wd, "--output-dir", out_dir]
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    if rescue_2d.main(argv) != 0:
        fail("rescue_2d returned non-zero")
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    on = ("pack", "realign", "traceback")
    if min(launches[k] for k in on) <= 0 or any(
            v for k, v in launches.items() if k not in on):
        fail("rescue_2d launches %s: want %s > 0 and the rest 0"
             % (launches, on))
    tables = {}
    for read_type in ("template", "complement"):
        with open(os.path.join(out_dir, read_type + "_metrics.tsv")) as fh:
            lines = fh.read().splitlines()
        if lines[0] + "\n" != rescue_2d.HEADER:
            fail("rescue_2d %s header %r" % (read_type, lines[0]))
        rows = {line.split("\t")[0]: line + "\n" for line in lines[1:]}
        if len(lines) - 1 != len(mapped) or set(rows) != set(mapped):
            fail("rescue_2d %s: %d rows for %d mapped 2D reads"
                 % (read_type, len(lines) - 1, len(mapped)))
        tables[read_type] = rows
    cols = rescue_2d.HEADER.rstrip("\n").split("\t")
    fwd = [row.split("\t") for name, row in tables["template"].items()
           if name.endswith("_0")]
    ident = float(np.median([float(r[cols.index("Identity")]) for r in fwd]))
    cover = float(np.median([float(r[cols.index("ReferenceCoverage")])
                             for r in fwd]))
    print("rescue_2d: %d mapped 2D reads rescued as template and as "
          "complement in %.3f s; forward-strand reads (%d): median Identity "
          "%.5f, median ReferenceCoverage %.5f; launches %s"
          % (len(mapped), wall, len(fwd), ident, cover, launches))
    if not ident > RESCUE_IDENTITY:
        fail("rescue_2d median Identity %.5f" % ident)

    # a few jobs, one of each strand, as one batch on the card and the CPU
    ref = read_fasta_dict(os.path.join(wd, "referenceFastaFiles", "ref.fa"))
    seqs = read_fastq_dict(fq)
    names = [next(n for n in mapped if n.endswith("_%d" % strand))
             for strand in (0, 1)][:RESCUE_CPU_JOBS]
    jobs = [(n, mapped[n].rname, seqs[n],
             ref[mapped[n].rname][mapped[n].pos:mapped[n].aend])
            for n in names]
    t0 = time.perf_counter()
    got = {}
    for d in (dev, "cpu"):
        params = make_kernel_params(PairHmmModel.default(), device=d)
        got[str(d)] = rescue_2d.rescue_metrics(jobs, params, W, len(jobs), d)
    want = [tables["template"][n] for n in names]
    print("rescue_2d, card against CPU: %d jobs as one batch, rows %s "
          "(%.1f s)" % (len(jobs), "identical" if got[str(dev)] == got["cpu"]
                        == want else "DIFFER", time.perf_counter() - t0))
    if not got[str(dev)] == got["cpu"] == want:
        fail("rescue_2d rows: card %s, CPU %s, the script's %s"
             % (got[str(dev)], got["cpu"], want))
    print("phase 11 wall: %.1f s (rescue_2d %.1f s)"
          % (time.perf_counter() - t_phase, wall))
    return launches


# phase 12: the multi-host pipeline's arguments (the EM depth is phase
# 10's cut)
DIST_MAPPERS = ["LastParamsChain", "LastParamsRealignEm"]
DIST_ARGS = ["--max-threads", "4", "--mappers", ",".join(DIST_MAPPERS),
             "--analyses", "GlobalCoverage,Substitutions", "--meta-analyses",
             "CoverageSummary", "--em-trials", "1", "--em-iterations", "5"]
DIST_RANKS = 2
DIST_TIMEOUT = 600  # seconds the ranks may take together


def distributed_rank(rank: int, port: str, wd: str, out: str) -> int:
    """Run as ``chip_smoke.py --rank <i> <port> <wd> <out>``: one rank of
    phase 12, ``cli.main(["run", wd, ...])`` under the three variables of
    the multi-host run, every counter set to 0 just before; writes its
    launches and wall to ``out``."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch import cli

    os.environ.update(NANOPORE_TPU_COORDINATOR="localhost:" + port,
                      NANOPORE_TPU_NUM_PROCESSES=str(DIST_RANKS),
                      NANOPORE_TPU_PROCESS_ID=str(rank))
    counters = launch_counters()
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    if cli.main(["run", wd] + DIST_ARGS) != 0:
        fail("rank %d: the pipeline returned non-zero" % rank)
    torch.cuda.synchronize()
    with open(out, "w") as fh:
        json.dump({"wall": time.perf_counter() - t0,
                   "launches": {c.name: c.count for c in counters}}, fh)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def model_numbers(path: str) -> np.ndarray:
    """A model file's transitions, likelihood and emissions."""
    from nanopore_tpu_torch.align.model import PairHmmModel

    m = PairHmmModel.load(path)
    return np.concatenate([m.transitions.ravel(), [m.likelihood],
                           m.emissions.ravel()])


def distributed_phase(workdir: str) -> dict:
    """Phase 12: the pipeline on two ranks over gloo, both on this card,
    on phase 10's reads and reference; its chain SAM and its EM model
    held against phase 10's.  Returns the launches summed over the
    ranks."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    wd10 = os.path.join(workdir, "pipeline", "wd")
    root = os.path.join(workdir, "distributed")
    shutil.rmtree(root, ignore_errors=True)
    wd = os.path.join(root, "wd")
    for sub in ("readFastqFiles", "referenceFastaFiles"):
        shutil.copytree(os.path.join(wd10, sub), os.path.join(wd, sub))
    torch.cuda.empty_cache()  # phases 10-11's cached blocks
    port = str(free_port())
    print("distributed pipeline: %d ranks on one card, gloo at localhost:%s:"
          " run %s %s" % (DIST_RANKS, port, wd, " ".join(DIST_ARGS)))
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(DIST_RANKS):
        logs.append(os.path.join(root, "rank%d.log" % r))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 port, wd, os.path.join(root, "rank%d.json" % r)],
                stdout=log, stderr=subprocess.STDOUT, text=True))
    try:
        rcs = [p.wait(timeout=DIST_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if rcs != [0] * DIST_RANKS:
        for path in logs:
            with open(path) as fh:
                print("".join(fh.readlines()[-30:]))
        fail("distributed pipeline: rank exit codes %s (None: past %d s)"
             % (rcs, DIST_TIMEOUT))
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(root, "rank%d.json" % r)) as fh:
            ranks.append(json.load(fh))

    out, out10 = os.path.join(wd, "output"), os.path.join(wd10, "output")
    tasks = {}
    for name in ["pipeline_stats.json"] + [
            "pipeline_stats.host%d.json" % r for r in range(1, DIST_RANKS)]:
        with open(os.path.join(out, name)) as fh:
            tasks.update(json.load(fh))
    bad = {k: (v["status"], v["attempts"]) for k, v in tasks.items()
           if v["status"] != "done" or v["attempts"] != 1}
    if bad or len(tasks) != len(DIST_MAPPERS) * 2:
        fail("distributed pipeline tasks not done on their first attempt: "
             "%s (%d tasks)" % (bad, len(tasks)))
    base, base10 = (os.path.join(d, "analysis_2d") for d in (out, out10))
    litter = [f for m in DIST_MAPPERS for f in os.listdir(os.path.join(
        base, "experiment_reads.fq_ref.fa_" + m)) if ".shard" in f
        or ".rshard" in f or f.endswith(".ckpt.npz")]
    if litter:
        fail("distributed pipeline left %s" % litter)
    chain = os.path.join("experiment_reads.fq_ref.fa_LastParamsChain",
                         "mapping.sam")
    with open(os.path.join(base, chain), "rb") as a, \
            open(os.path.join(base10, chain), "rb") as b:
        chain_same = a.read() == b.read()
    em_dir = "experiment_reads.fq_ref.fa_LastParamsRealignEm"
    got, want = (model_numbers(os.path.join(d, em_dir, "hmm.txt_unnormalised"))
                 for d in (base, base10))
    nz = want != 0
    model_err = float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])))

    def records(d):
        with open(os.path.join(d, em_dir, "mapping.sam")) as fh:
            return [ln.split("\t")[:4] for ln in fh if not ln.startswith("@")]

    em_records_same = records(base) == records(base10)
    print("distributed pipeline: %d ranks in %.3f s (rank walls %s); "
          "LastParamsChain mapping.sam %s phase 10's; LastParamsRealignEm "
          "model largest relative difference from phase 10's %.3g, records "
          "%s in their first four fields; launches %s"
          % (DIST_RANKS, wall, [round(r["wall"], 3) for r in ranks],
             "byte-identical to" if chain_same else "DIFFERS from", model_err,
             "equal" if em_records_same else "DIFFERENT",
             [r["launches"] for r in ranks]))
    if not chain_same:
        fail("the distributed LastParamsChain mapping.sam differs")
    if not (np.array_equal(got != 0, nz) and model_err <= 1e-9):
        fail("the distributed EM model differs from phase 10's by %.3g"
             % model_err)
    if not em_records_same:
        fail("the distributed LastParamsRealignEm records differ")
    on = ("pack", "realign", "traceback", "realign_em")
    for r, res in enumerate(ranks):
        launches = res["launches"]
        if min(launches[k] for k in on) <= 0 or any(
                v for k, v in launches.items() if k not in on):
            fail("rank %d launches %s: want %s > 0 and the rest 0"
                 % (r, launches, on))
    print("phase 12 wall: %.1f s (the ranks %.1f s)"
          % (time.perf_counter() - t_phase, wall))
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


# ---- phase 13: live band widths in the W = 32 and W = 64 kernels ---- #

def live_batch(pairs, w: int, dev, lanes=None):
    """Pack ``pairs`` as a band of live width ``w`` in ``lanes`` lanes
    (default ``padded_width(w)``), as ``prepared_from_pairs`` lays a
    batch out: (xyc, m, n, prep, stream inputs)."""
    import torch

    from nanopore_tpu_torch.ops.pack import (
        pack_stream_pairs,
        pack_xyc,
        padded_width,
    )

    prep = pack_stream_pairs(pairs, w, None, lanes=lanes or padded_width(w))
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    m, n = put(prep["m"]), put(prep["n"])
    stream, initx = put(prep["stream"]), put(prep["initx"])
    return pack_xyc(stream, initx, m, n, band_width=w), m, n, prep, (
        stream, initx)


def width_kernel_checks(pairs, w: int, dev, res: dict,
                        phase: str = "phase 13", viterbi: bool = True,
                        mea: bool = True, every_step: bool = False) -> None:
    """Every kernel against its plain version on a band of live width
    ``w`` in the padded layout, timed there and as a band of the
    layout's full width; into ``res[kernel]`` under ``*_w<w>`` (under
    ``*_live<w>`` where w is the layout's full width, whose ``*_w<w>``
    keys are the mapping batch's).  With ``viterbi=False`` the MEA
    path's kernels alone, with ``mea=False`` the Viterbi path's alone
    (the other path's phase times them at this width); ``every_step``
    adds the Viterbi path's other steps (:func:`viterbi_width_rows`)."""
    import torch

    from nanopore_tpu_torch.align.em import representable
    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.ops.pack import SENT, pack_xyc, pack_xyc_plain
    from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
    from nanopore_tpu_torch.ops.realign import (
        DIR_NONE,
        realign_decode,
        realign_decode_plain,
        realign_em,
        realign_em_plain,
        realign_exp,
        realign_exp_plain,
        realign_gamma,
        realign_gamma_plain,
    )
    from nanopore_tpu_torch.ops.traceback import mea_walk, mea_walk_plain

    t0 = time.perf_counter()
    xyc, m, n, prep, (stream, initx) = live_batch(pairs, w, dev)
    B, k_pad, W_ = xyc.shape
    tag = ("_w%d" if w < W_ else "_live%d") % w
    kend = prep["k_end"]
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    # the same reads as a band of the layout's full width
    fx, fm, fn_, fprep, (fstream, finitx) = live_batch(pairs, W_, dev)
    print("%s, w = %d in W = %d: B=%d k_pad=%d (full width: k_pad %d)"
          % (phase, w, W_, B, k_pad, fprep["k_pad"]))
    dflt = make_kernel_params(PairHmmModel.default())
    # EM under a random restart, as em_train draws it
    rand = make_kernel_params(PairHmmModel.random(np.random.default_rng(SEED)))
    rows = {}

    def row(name, ms, ms_full, plain_ms, err, ops_per_cell, nbytes,
            sfx=""):
        if ops_per_cell:
            bound, by = realign_bound(ops_per_cell, w, need, nbytes)
        else:
            bound, by = nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
        t = sfx + tag
        rows.setdefault(name, {}).update({
            "ms" + t: ms, "ms_full" + t: ms_full, "plain_ms" + t: plain_ms,
            "max_abs_err" + t: err, "bound_ms" + t: bound,
            "bound_by" + t: by, "reads" + tag: B, "k_pad" + tag: k_pad})
        print("  %s%s w=%d: %.3f ms (%.3f ms at the full W = %d), bound "
              "%.4f ms (%s), plain %.1f ms, max abs err %.3g"
              % (name, sfx, w, ms, ms_full, W_, bound, by, plain_ms, err))

    def finish():
        for name, r in rows.items():
            res.setdefault(name, {}).update(r)
        print("%s, w = %d: %.1f s" % (phase, w, time.perf_counter() - t0))

    if not mea:
        viterbi_width_rows(xyc, m, n, dflt, w, need, prep["offsets"],
                           (fx, fm, fn_), row, every_step)
        return finish()
    # K1: byte for byte, every dead lane the sentinel with its row's bits
    xyc_p, plain_ms = timed(lambda: pack_xyc_plain(stream, initx, m, n, w))
    codes = xyc.view(torch.uint8)
    dead = codes[:, :, w:]
    if not torch.equal(xyc, xyc_p) or not bool(
            ((dead & 0x3F) == SENT).all()
            and ((dead & 0xC0) == (codes[:, :, :1] & 0xC0)).all()):
        fail("pack kernel at w=%d differs from its plain version or writes "
             "a live code in a dead lane" % w)
    row("pack", cuda_ms(lambda: pack_xyc(stream, initx, m, n, w), 5),
        cuda_ms(lambda: pack_xyc(fstream, finitx, fm, fn_), 5, warmup=False),
        plain_ms, 0.0, 0, B * k_pad + B * W_ + 8 * B + B * k_pad * w)

    # K2 decode and decode + gamma; K3 on the kernel's direction codes
    for name, gam in (("realign", False), ("realign_decode_gamma", True)):
        out_k = realign_decode(xyc, m, n, dflt, emit_gamma=gam, kend=kend,
                               band_width=w)
        out_p, plain_ms = timed(lambda: realign_decode_plain(
            xyc, m, n, dflt, emit_gamma=gam, band_width=w))
        ll_rel = rel_err(out_k["loglik"], out_p["loglik"])
        sc_rel = rel_err(out_k["score"], out_p["score"])
        dirs_rows = int((out_k["dirs"] != out_p["dirs"]).flatten(1).any(1)
                        .sum())
        err = float(torch.maximum(
            (out_k["loglik"] - out_p["loglik"]).abs().max(),
            (out_k["score"] - out_p["score"]).abs().max()))
        if gam:
            err = max(err, finite_err(out_k, out_p, ("gamma",), B, name))
        dead_none = bool((out_k["dirs"][:, :, w:] == DIR_NONE).all())
        print("  %s w=%d: loglik max rel %.3g, score max rel %.3g, reads "
              "with differing direction codes %d of %d, dead lanes DIR_NONE "
              "%s%s" % (name, w, ll_rel, sc_rel, dirs_rows, B, dead_none,
                        ", gamma max abs err %.3g" % err if gam else ""))
        if (ll_rel > 1e-5 or sc_rel > 1e-4 or dirs_rows > 0.01 * B
                or not dead_none or err > (5e-5 if gam else np.inf)):
            fail("%s at w=%d outside tolerance" % (name, w))
        out_bytes = B * (k_pad + 1) * w * (5 if gam else 1)
        row(name, cuda_ms(lambda: realign_decode(
                xyc, m, n, dflt, emit_gamma=gam, kend=kend, band_width=w), 3),
            cuda_ms(lambda: realign_decode(fx, fm, fn_, dflt, emit_gamma=gam,
                                           kend=fprep["k_end"]), 3,
                    warmup=False),
            plain_ms, err, REALIGN_OPS_PER_CELL,
            B * k_pad * w + out_bytes + 16 * B)
        if gam:
            continue
        dirs_k = out_k["dirs"]
        ops_k = mea_walk(dirs_k, xyc, m, n)
        ops_p, plain_ms = timed(lambda: mea_walk_plain(dirs_k, xyc, m, n))
        if not torch.equal(ops_k, ops_p):
            fail("MEA walker at w=%d differs from its plain version" % w)
        left = walks_leaving(ops_k.cpu().numpy(), prep["offsets"], w)
        print("  traceback w=%d: ops identical, walks leaving the live band "
              "%d" % (w, left))
        if left:
            fail("%d MEA walks leave the live band at w=%d" % (left, w))
        fdirs = realign_decode(fx, fm, fn_, dflt, kend=fprep["k_end"])["dirs"]
        row("traceback", cuda_ms(lambda: mea_walk(dirs_k, xyc, m, n), 10),
            cuda_ms(lambda: mea_walk(fdirs, fx, fm, fn_), 10, warmup=False),
            plain_ms, 0.0, 0, walked_bytes(ops_k) + need - B
            + B * (k_pad + 1) + 8 * B)

    # K2-em, K2-gamma, K2-exp
    out_k = realign_em(xyc, m, n, rand, kend=kend, band_width=w)
    out_p, plain_ms = timed(lambda: realign_em_plain(xyc, m, n, rand, w))
    held = torch.from_numpy(representable(
        out_k["trans"].double().cpu().numpy(),
        out_k["emis"].double().cpu().numpy(), prep["m"], prep["n"])).to(dev)
    rels, err = [rel_err(out_k["loglik"], out_p["loglik"])], 0.0
    for key in ("trans", "emis"):
        a, b = out_k[key].flatten(1)[held], out_p[key].flatten(1)[held]
        if not len(a):  # no read representable (every read held below)
            rels.append(0.0)
            continue
        rels.append(float(((a - b).abs().amax(1) / b.abs().amax(1)).max()))
        err = max(err, float((a - b).abs().max()))
    # every read, representable or not: the plain version's values, NaN
    # where it has NaN (what the kernel reaches); a band so wide that the
    # f32 recursion loses most reads' sums under the random start (the
    # JAX package's XLA scan loses them too) is held to that instead of
    # to its representable reads alone
    same = all(nan_equal(out_k[key], out_p[key])
               for key in ("loglik", "trans", "emis"))
    print("  realign_em w=%d: loglik max rel %.3g, trans and emis max rel "
          "to the table's largest entry %.3g, %.3g (%d of %d reads "
          "representable); every read's outputs the plain version's %s"
          % (w, *rels, int(held.sum()), B, same))
    if rels[0] > 1e-5 or max(rels[1:]) > 3e-5 or (
            int(held.sum()) < 0.9 * B and not same):
        fail("EM mode at w=%d outside tolerance" % w)
    row("realign_em", cuda_ms(lambda: realign_em(
            xyc, m, n, rand, kend=kend, band_width=w), 3),
        cuda_ms(lambda: realign_em(fx, fm, fn_, rand, kend=fprep["k_end"]),
                3, warmup=False),
        plain_ms, err, REALIGN_EM_OPS_PER_CELL,
        B * k_pad * w + 8 * B + B * 106 * 4)
    out_k = realign_gamma(xyc, m, n, dflt, kend=kend, band_width=w)
    out_p, plain_ms = timed(lambda: realign_gamma_plain(xyc, m, n, dflt, w))
    err = finite_err(out_k, out_p, ("loglik", "gamma"), B, "realign_gamma")
    ll_rel = rel_err(out_k["loglik"], out_p["loglik"])
    dead_zero = bool((out_k["gamma"][:, :, w:] == 0).all())
    print("  realign_gamma w=%d: loglik max rel %.3g, gamma max abs err "
          "%.3g, dead lanes 0 %s" % (w, ll_rel, err, dead_zero))
    if ll_rel > 1e-5 or err > 5e-5 or not dead_zero:
        fail("gamma mode at w=%d outside tolerance" % w)
    row("realign_gamma", cuda_ms(lambda: realign_gamma(
            xyc, m, n, dflt, kend=kend, band_width=w), 3),
        cuda_ms(lambda: realign_gamma(fx, fm, fn_, dflt, kend=fprep["k_end"]),
                3, warmup=False),
        plain_ms, err, REALIGN_GAMMA_OPS_PER_CELL,
        B * k_pad * w + B * (k_pad + 1) * w * 4 + 12 * B)
    out_k = realign_exp(xyc, m, n, dflt, SNP_THRESHOLD, kend=kend,
                        band_width=w)
    out_p, plain_ms = timed(lambda: realign_exp_plain(
        xyc, m, n, dflt, SNP_THRESHOLD, w))
    err = finite_err(out_k, out_p, ("ret", "flush"), B, "realign_exp")
    ll_rel = rel_err(out_k["loglik"], out_p["loglik"])
    dead_zero = bool((out_k["flush"][:, :, w:] == 0).all())
    print("  realign_exp w=%d: loglik max rel %.3g, retire rows and flush "
          "max abs err %.3g, dead flush columns 0 %s"
          % (w, ll_rel, err, dead_zero))
    if ll_rel > 1e-5 or err > 5e-5 or not dead_zero:
        fail("exp mode at w=%d outside tolerance" % w)
    row("realign_exp", cuda_ms(lambda: realign_exp(
            xyc, m, n, dflt, SNP_THRESHOLD, kend=kend, band_width=w), 3),
        cuda_ms(lambda: realign_exp(fx, fm, fn_, dflt, SNP_THRESHOLD,
                                    kend=fprep["k_end"]), 3, warmup=False),
        plain_ms, err, REALIGN_EXP_OPS_PER_CELL,
        B * k_pad * w + B * (k_pad + 1) * 16 + B * 4 * w * 4 + 12 * B)

    if viterbi:
        viterbi_width_rows(xyc, m, n, dflt, w, need, prep["offsets"],
                           (fx, fm, fn_), row, every_step)
    finish()


def viterbi_width_rows(xyc, m, n, dflt, w: int, need: int, offsets, full,
                       row, every_step: bool = False) -> None:
    """K4, K5 and K6 against their plain versions on phase 13's band of
    live width ``w``, timed there and on ``full`` (the same reads as a
    band of the layout's full width); each row through ``row``.  The
    default model takes K4's short step and K6's two-term sum; with
    ``every_step`` also K4's 5-way step and K6's 5-way sum (each against
    the same plain run, bit for bit), and K4-full and K5-full under
    phase 14's first model (:func:`full_plane_models`)."""
    import torch

    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops import viterbi as V
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables
    from nanopore_tpu_torch.ops.traceback import (
        viterbi_walk,
        viterbi_walk_plain,
    )

    B, k_pad = xyc.shape[:2]
    fx, fm, fn_ = full
    out_k = V.viterbi_forward(xyc, m, n, dflt)
    out_p, plain_ms = timed(lambda: V.viterbi_forward_plain(xyc, m, n, dflt))
    sc_rel = rel_err(out_k["score"], out_p["score"])
    same = (torch.equal(out_k["bp"], out_p["bp"])
            and torch.equal(out_k["fstate"], out_p["fstate"]))
    print("  viterbi w=%d: score max rel %.3g, plane and fstate %s"
          % (w, sc_rel, "byte-identical" if same else "DIFFERENT"))
    if sc_rel > 1e-5 or not same:
        fail("Viterbi kernel at w=%d outside tolerance" % w)
    plane = B * k_pad * w + B * (k_pad + 1) * w + 8 * B
    row("viterbi", cuda_ms(lambda: V.viterbi_forward(xyc, m, n, dflt), 5),
        cuda_ms(lambda: V.viterbi_forward(fx, fm, fn_, dflt), 5,
                warmup=False),
        plain_ms, float((out_k["score"] - out_p["score"]).abs().max()),
        VITERBI_SHORT_OPS_PER_CELL, plane)

    def bits_of(what, got, want):
        differ = [key for key in want if not bits_equal(got[key], want[key])]
        print("  %s w=%d: score, fstate and whole plane %s"
              % (what, w, "bit-identical" if not differ
                 else "DIFFERENT in %s" % differ))
        if differ:
            fail("%s at w=%d differs from its plain version" % (what, w))

    if every_step:
        byte = V.viterbi_tables(dflt)
        if not V.short_step(byte):
            fail("the default model does not take K4's short step")
        bits_of("viterbi (5-way step)",
                V._launch(xyc, m, n, byte, V.FIVE_WAY), out_p)
        row("viterbi",
            cuda_ms(lambda: V._launch(xyc, m, n, byte, V.FIVE_WAY), 5),
            cuda_ms(lambda: V._launch(fx, fm, fn_, byte, V.FIVE_WAY), 5,
                    warmup=False),
            plain_ms, 0.0, VITERBI_OPS_PER_CELL, plane, "_5way")
    del out_p

    def walk_rows(name, out, fout, per_step):
        args = (out["bp"], xyc, m, n, out["fstate"])
        walk_k = viterbi_walk(*args)
        walk_p, walk_ms = timed(lambda: viterbi_walk_plain(*args))
        if not all(torch.equal(a, b) for a, b in zip(walk_k, walk_p)):
            fail("%s at w=%d differs from its plain version" % (name, w))
        left = walks_leaving(walk_k[0].cpu().numpy(), offsets, w)
        print("  %s w=%d: ops and end cells identical, walks short of the "
              "origin %d, walks leaving the live band %d"
              % (name, w, int(walk_k[1].any(1).sum()), left))
        if left or bool(walk_k[1].any()):
            fail("%s walks at w=%d leave the live band or stop short"
                 % (name, w))
        row(name, cuda_ms(lambda: viterbi_walk(*args), 10),
            cuda_ms(lambda: viterbi_walk(fout["bp"], fx, fm, fn_,
                                         fout["fstate"]), 10, warmup=False),
            walk_ms, 0.0, 0, per_step * walked_bytes(walk_k[0]) + need - B
            + B * (k_pad + 1) + 16 * B)

    walk_rows("viterbi_traceback", out_k,
              V.viterbi_forward(fx, fm, fn_, dflt), 1)
    del out_k
    if every_step:
        full_p = next(iter(full_plane_models(dflt).values()))
        if V.viterbi_structure_ok(full_p):
            fail("phase 14's first model does not take the full plane")
        out_f = V.viterbi_forward(xyc, m, n, full_p)
        if out_f["bp"].dtype != torch.int16:
            fail("the Viterbi did not take the full plane at w=%d" % w)
        want, plain_ms = timed(lambda: V.viterbi_forward_full_plain(
            xyc, m, n, full_p))
        bits_of("viterbi_full", out_f, want)
        del want
        row("viterbi_full",
            cuda_ms(lambda: V.viterbi_forward(xyc, m, n, full_p), 5),
            cuda_ms(lambda: V.viterbi_forward(fx, fm, fn_, full_p), 5,
                    warmup=False),
            plain_ms, 0.0, VITERBI_OPS_PER_CELL,
            B * k_pad * w + B * (k_pad + 1) * w * 2 + 8 * B)
        walk_rows("viterbi_traceback_full", out_f,
                  V.viterbi_forward(fx, fm, fn_, full_p), 2)
        del out_f
    ll_k = F.forward_loglik(xyc, m, n, dflt)
    ll_p, plain_ms = timed(lambda: F.forward_loglik_plain(xyc, m, n, dflt))
    ll_rel = rel_err(ll_k, ll_p)
    print("  forward w=%d: loglik max rel %.3g (%s)"
          % (w, ll_rel, "bit-identical" if bits_equal(ll_k, ll_p)
             else "not bit-identical"))
    if ll_rel > 1e-5:
        fail("forward kernel at w=%d outside tolerance" % w)
    row("forward", cuda_ms(lambda: F.forward_loglik(xyc, m, n, dflt), 5),
        cuda_ms(lambda: F.forward_loglik(fx, fm, fn_, dflt), 5, warmup=False),
        plain_ms, float((ll_k - ll_p).abs().max()),
        FORWARD_SHORT_OPS_PER_CELL, B * k_pad * w + 12 * B)
    if every_step:
        tab = kernel_tables(dflt)
        if not F.two_term_sum(tab):
            fail("the default model does not take K6's two-term sum")
        ll_5 = F._launch(xyc, m, n, tab, False)["loglik"]
        ll_rel = rel_err(ll_5, ll_p)
        print("  forward (5-way sum) w=%d: loglik max rel %.3g (%s)"
              % (w, ll_rel, "bit-identical" if bits_equal(ll_5, ll_p)
                 else "not bit-identical"))
        if ll_rel > 1e-5:
            fail("forward kernel's 5-way sum at w=%d outside tolerance" % w)
        row("forward", cuda_ms(lambda: F._launch(xyc, m, n, tab, False), 5),
            cuda_ms(lambda: F._launch(fx, fm, fn_, tab, False), 5,
                    warmup=False),
            plain_ms, float((ll_5 - ll_p).abs().max()),
            FORWARD_OPS_PER_CELL, B * k_pad * w + 12 * B, "_5way")


def walks_leaving(ops, offsets, w: int) -> int:
    """Walks of op codes (0 match, 1 delete, 2 insert, 3 none; from the
    origin, ``ops.traceback``'s order) that visit a band lane outside
    0..w-1."""
    left = 0
    for b in range(ops.shape[0]):
        row = ops[b][ops[b] != 3]
        di = (row != 1).astype(np.int64)  # match and insert take a read base
        dj = (row != 2).astype(np.int64)  # match and delete a reference base
        j = np.concatenate([[0], np.cumsum(dj)])
        k = np.concatenate([[0], np.cumsum(di + dj)])
        lanes = j - offsets[b][k]
        left += int(((lanes < 0) | (lanes >= w)).any())
    return left


def width_workload(workdir: str, dev=None) -> dict:
    """Phase 13's reads (its checks in the docstring's step 13), which
    phases 15-18 take too: 80 reads of 700-1300 bases on the 48,502-bp
    reference, mapped with ``LastParams`` on ``dev`` and chained; the 64
    whose windows of pad 128 miss the reference's far end.  With no
    ``dev`` (the CPU halves' process) the workload a card run wrote
    under ``workdir`` is read back.  Returns the paths (``fa``, ``fq``,
    the mapping ``sam``), their chained records and their (window,
    read, guide) pairs."""
    from nanopore_tpu_torch.align.chain_sam import chain_sam_file
    from nanopore_tpu_torch.io.sam import SamReader
    from nanopore_tpu_torch.mapping.runner import run_mapper

    wdir = os.path.join(workdir, "widths")
    fa, fq, sam, chained = (os.path.join(wdir, f) for f in (
        "ref.fa", "reads.fq", "mapping.sam", "chained.sam"))
    if dev is not None:
        write_workload(wdir, EM_REF_LEN, WIDTH_READS + 16, WIDTH_READ_LENS)
        run_mapper("LastParams", fq, "reads", fa, sam, device=dev)
        chain_sam_file(sam, chained, fq, fa)
    # a window that reaches the reference's end (ROADMAP C6) would set
    # every batch's diagonal count: the reads whose windows do not
    pairs = chained_pairs(chained, fa, 128)
    near = [i for i, (x, y, _) in enumerate(pairs)
            if len(x) + len(y) <= WIDTH_MAX_K][:WIDTH_READS]
    if len(near) != WIDTH_READS:
        fail("phase 13: %d of %d chained reads off the far end"
             % (len(near), len(pairs)))
    every = list(SamReader(chained).mapped())
    return {"dir": wdir, "fa": fa, "fq": fq, "sam": sam,
            "recs": [every[i] for i in near],
            "pairs": [pairs[i] for i in near]}


def realign_subset(wl: dict):
    """The ``realign`` checks' input: 8 of the workload's records (4
    shorter than 1,000 bases, 4 longer: two window shapes, so two
    batches) as a SAM in the workload's directory.  Returns the
    ``realign`` subcommand's input paths and the records' names."""
    recs, wdir = wl["recs"], wl["dir"]
    short = [r.qname for r in recs if len(r.seq) < 1000][:WIDTH_CLI_RECORDS]
    long_ = [r.qname for r in recs if len(r.seq) > 1100][:WIDTH_CLI_RECORDS]
    keep = set(short + long_)
    sub = os.path.join(wdir, "subset.sam")
    with open(wl["sam"]) as src, open(sub, "w") as dst:
        for line in src:
            if line.startswith("@") or line.split("\t", 1)[0] in keep:
                dst.write(line)
    return [sub, wl["fq"], wl["fa"]], keep, len(short), len(long_)


def realign_cli_check(wl: dict, w: int, counters, phase: str) -> dict:
    """``cli realign --band-width w`` on :func:`realign_subset`'s 8
    records, every counter set to 0 just before, against the same
    command with ``--device cpu`` (run by the CPU halves' process):
    records identical; pack, realign and traceback launched more than
    once, nothing else.  Returns the launches."""
    import torch

    from nanopore_tpu_torch import cli
    from nanopore_tpu_torch.io.sam import SamReader

    args, keep, n_short, n_long = realign_subset(wl)
    out_k = os.path.join(wl["dir"], "realign_w%d_card.sam" % w)
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    cli.main(["realign", *args, out_k, "--band-width", str(w)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = {c.name: c.count for c in counters}
    half = cpu_half(half_key("realign", w))
    out_c, cpu_wall = half["path"], half["wall"]
    got, want = (list(SamReader(p)) for p in (out_k, out_c))
    same = [(a.qname, a.pos, a.cigar) for a in got] == [
        (a.qname, a.pos, a.cigar) for a in want]
    print("%s: realign --band-width %d on %d records (%d short, %d long): "
          "%.3f s on the card, %.1f s on the CPU; records %s; launches %s"
          % (phase, w, len(got), n_short, n_long, wall, cpu_wall,
             "identical" if same else "DIFFERENT", r))
    if len(got) != len(keep) or not same:
        fail("realign --band-width %d: the card's records differ from the "
             "CPU's" % w)
    if min(r[k] for k in ("pack", "realign", "traceback")) < 2 or any(
            v for k, v in r.items() if k not in ("pack", "realign",
                                                 "traceback")):
        fail("realign --band-width %d launches: %s" % (w, r))
    return r


def em_width_run(wl: dict, w: int, device):
    """``em_train`` at ``EmOptions(band_width=w, trials=1,
    iterations=2)`` on 16 of the workload's chained reads on ``device``
    (above W = 256 with ``window_pad=EM_WIDEST_PAD``)."""
    from nanopore_tpu_torch.align.em import EmOptions, em_train
    from nanopore_tpu_torch.io.encoding import encode
    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    ref = {k: encode(v) for k, v in read_fasta_dict(wl["fa"]).items()}
    em_pairs = [(ref[rec.rname], encode(rec.seq), rec.cigar)
                for rec in wl["recs"][:WIDTH_EM_READS]]
    opts = EmOptions(band_width=w, trials=1, iterations=2,
                     batch_size=WIDTH_EM_READS, window_pad=em_pad(w))
    return em_train(em_pairs, opts, device=device)


def em_pad(w: int) -> int:
    """:func:`em_width_run`'s window pad at band width ``w``."""
    from nanopore_tpu_torch.align.em import EmOptions

    return EM_WIDEST_PAD if w > WIDER_W else EmOptions.window_pad


def em_width_check(wl: dict, w: int, dev, counters, phase: str) -> dict:
    """:func:`em_width_run` on the card, every counter set to 0 just
    before, against its run on the CPU (by the CPU halves' process): the
    model within 3e-5 relative.  Returns the launches."""
    import torch

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    card = em_width_run(wl, w, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = {c.name: c.count for c in counters}
    half = cpu_half(half_key("em", w))
    with np.load(half["path"]) as host:
        trans, emis, running = (host[k] for k in (
            "transitions", "emissions", "running"))
    diff = max(
        float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
        for a, b in ((card.model.transitions, trans),
                     (card.model.emissions, emis)))
    print("%s: em_train at w = %d (1 trial x 2 iterations, %d reads, "
          "window pad %d): "
          "%.3f s on the card, %.1f s on the CPU; model max relative "
          "difference %.3g; running likelihoods %s and %s; launches %s"
          % (phase, w, WIDTH_EM_READS, em_pad(w), wall, half["wall"], diff,
             card.running_likelihoods[0], list(running), r))
    if diff > 3e-5:
        fail("EM at w = %d: the card's model differs from the CPU's by %.3g"
             % (w, diff))
    if min(r[k] for k in ("pack", "realign_em")) <= 0:
        fail("EM at w = %d launches: %s" % (w, r))
    return r


def widths_phase(wl: dict, dev, counters) -> dict:
    """Phase 13 (its checks in the docstring's step 13) on
    :func:`width_workload`'s reads: returns the kernels' ``*_w<w>``
    numbers and the launches of the ``realign`` and ``em_train`` runs."""
    t_phase = time.perf_counter()
    res = {}
    for w in LIVE_WIDTHS:
        width_kernel_checks(wl["pairs"], w, dev, res)
    runs = {
        # the realign subcommand at the reference's production band
        "widths_realign": realign_cli_check(wl, 21, counters, "phase 13"),
        "widths_em": em_width_check(wl, 48, dev, counters, "phase 13"),
    }
    print("phase 13 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


# ---- phase 14: the full plane (a model outside the canonical structure) ---- #

def full_plane_models(params) -> dict:
    """The two non-canonical models of phase 14 over ``params``'
    emissions: tests/test_viterbi.py's (t[1 -> 2] = 0.05, its row
    renormalised; the kernels are timed under it) and a dense random one
    (every transition > 0)."""
    from nanopore_tpu_torch.ops.pairhmm import params_from_numpy

    t = np.random.default_rng(SEED + 14).uniform(0.02, 1.0, (5, 5))
    return {
        "t[1->2] = 0.05": edited_params(params, [(1, 2, 0.05)]),
        "dense": params_from_numpy(t / t.sum(axis=1, keepdims=True),
                                   params.e_match_flat.cpu().numpy(),
                                   params.e_gap_flat.cpu().numpy()),
    }


def full_plane_check(name, xyc, m, n, p, plain_args, want=None) -> dict:
    """K4's full plane against its plain version (score, fstate and the
    whole plane bit for bit; ``plain_args`` (xyc, m, n) a prefix of the
    batch's reads, or ``want`` the plain outputs already made), then K5's
    full-plane walk of the kernel's plane against the plain walker (ops
    and end cells).  Returns the kernel's outputs and the plain times."""
    import torch

    from nanopore_tpu_torch.ops import viterbi as V
    from nanopore_tpu_torch.ops.traceback import (
        viterbi_walk,
        viterbi_walk_plain,
    )

    out_k = V.viterbi_forward(xyc, m, n, p)
    if out_k["bp"].dtype != torch.int16:
        fail("phase 14, %s: the Viterbi did not take the full plane" % name)
    P = plain_args[0].shape[0]
    plain_ms = None
    if want is None:
        want, plain_ms = timed(lambda: V.viterbi_forward_full_plain(
            *plain_args, p))
    differ = [key for key in want
              if not bits_equal(out_k[key][:P], want[key])]
    if differ:
        fail("phase 14, %s: the full-plane Viterbi kernel differs from its "
             "plain version in %s" % (name, differ))
    args = (xyc, m, n, out_k["fstate"])
    ops_k, end_k = viterbi_walk(out_k["bp"], *args)
    (ops_p, end_p), walk_ms = timed(lambda: viterbi_walk_plain(
        out_k["bp"][:P].contiguous(), *plain_args,
        out_k["fstate"][:P].contiguous()))
    if not (torch.equal(ops_k[:P], ops_p) and torch.equal(end_k[:P], end_p)):
        fail("phase 14, %s: the full-plane walk differs from the plain "
             "walker" % name)
    return dict(out=out_k, want=want, ops=ops_k, end=end_k,
                plain_ms=plain_ms, walk_ms=walk_ms)


def full_plane_phase(engine, pairs, fa: str, fq: str, dev, counters,
                     res: dict) -> dict:
    """Phase 14 (its checks in the docstring's step 14): the full-plane
    K4 and K5 against their plain versions on the mapping batch and the
    W = 32 ragged batches under two non-canonical models, timed; then
    ``MappingEngine(model=<non-canonical>, decode="viterbi")`` on the
    card against the CPU, its launches read from counters set to 0 just
    before.  Returns those launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.ops import traceback, viterbi as V
    from nanopore_tpu_torch.ops.traceback import (
        rle_ops_batch,
        viterbi_walk,
        viterbi_walk_plain,
    )

    t_phase = time.perf_counter()
    models = full_plane_models(engine.params)
    for name, p in models.items():
        if V.viterbi_structure_ok(p):
            fail("phase 14: the %s model is canonical" % name)
    B, P = len(pairs), PLAIN_READS
    xyc, m, n, prep = device_batch(pairs, W, None, dev, "full-plane batch",
                                   check_pack=False)
    K1 = prep["k_pad"] + 1
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    plain_args = tuple(t[:P].contiguous() for t in (xyc, m, n))
    timed_name = next(iter(models))
    for name, p in models.items():
        t0 = time.perf_counter()
        r = full_plane_check(name, xyc, m, n, p, plain_args)
        lost = int(r["end"].any(1).sum())
        cigars = rle_ops_batch(r["ops"].cpu().numpy())
        whole = sum(
            sum(ln for op, ln in cig if op in (0, 1)) == mr
            and sum(ln for op, ln in cig if op in (0, 2)) == nr
            for cig, mr, nr in zip(cigars, prep["m"], prep["n"]))
        print("phase 14, %s, mapping batch W=%d (B=%d, k_pad %d): K4 full "
              "plane score, fstate and plane bit-identical on %d reads "
              "(plain %.1f ms); K5 full walk ops and end cells identical "
              "(plain %.1f ms); %d of %d walks reach the origin, %d cigars "
              "consume exactly m and n; score mean %.2f (%.1f s wall)"
              % (name, W, B, K1 - 1, P, r["plain_ms"], r["walk_ms"], B - lost,
                 B, whole, float(r["out"]["score"].mean()),
                 time.perf_counter() - t0))
        if lost or whole != B:
            fail("phase 14, %s: %d walks lost, %d of %d whole cigars"
                 % (name, lost, whole, B))
        if name == timed_name:
            kept, p_row = r, p
    # timed under the JAX test's model on the whole batch
    bp, fstate = kept["out"]["bp"], kept["out"]["fstate"]
    ms = cuda_ms(lambda: V.viterbi_forward(xyc, m, n, p_row), 3)
    bound, by = realign_bound(VITERBI_OPS_PER_CELL, W, need,
                              (need - B) * W + B * K1 * W * 2 + 12 * B)
    res["viterbi_full"] = dict(
        per_batch=launches_per_call(V.FULL_LAUNCHES, lambda: V.viterbi_forward(
            xyc, m, n, p_row)),
        ms=ms, plain_ms=kept["plain_ms"], plain_reads=P, max_abs_err=0.0,
        bound_ms=bound, bound_by=by,
    )
    print("K4 viterbi full plane: %.3f ms per batch of %d, bound %.4f ms (%s), "
          "plain %.1f ms on %d reads" % (ms, B, bound, by, kept["plain_ms"], P))
    ms = cuda_ms(lambda: viterbi_walk(bp, xyc, m, n, fstate), 10)
    # two plane bytes a walk step, a code byte a diagonal of each read, an
    # op byte a diagonal of the batch, m, n, fstate and the end cell
    nbytes = 2 * walked_bytes(kept["ops"]) + need - B + B * K1 + 20 * B
    res["viterbi_traceback_full"] = dict(
        per_batch=launches_per_call(traceback.VIT_FULL_LAUNCHES,
                                    lambda: viterbi_walk(bp, xyc, m, n, fstate)),
        ms=ms, plain_ms=kept["walk_ms"], plain_reads=P, max_abs_err=0.0,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    print("K5 viterbi walker, full plane: %.3f ms per batch, bound %.4f ms "
          "(bytes), plain %.1f ms on %d reads"
          % (ms, res["viterbi_traceback_full"]["bound_ms"], kept["walk_ms"], P))
    # beside them, in this process on the same reads: the byte plane's two
    # steps (the default model's tables) and the byte walk of its plane
    byte = V.viterbi_tables(engine.params)
    step_ms = {what: cuda_ms(lambda: V._launch(xyc, m, n, byte, step), 3,
                             warmup=False)
               for what, step in (("short", V.SHORT), ("5-way", V.FIVE_WAY))}
    out_b = V._launch(xyc, m, n, byte, V.SHORT)
    walk_b = cuda_ms(lambda: viterbi_walk(out_b["bp"], xyc, m, n,
                                          out_b["fstate"]), 10, warmup=False)
    print("phase 14, the same batch: K4 full plane %.3f ms against the byte "
          "plane's short step %.3f ms and 5-way step %.3f ms; K5 full walk "
          "%.3f ms against the byte walk %.3f ms"
          % (res["viterbi_full"]["ms"], step_ms["short"], step_ms["5-way"],
             ms, walk_b))
    del out_b
    del kept, bp, fstate, xyc, m, n, plain_args

    # ---- the W = 32 ragged batches; random full planes at 64 and 32 ----
    t0 = time.perf_counter()
    batches, rprep = ragged_batches(dev, W_REALIGN)
    for name, p in models.items():
        want = {}
        for bname, x_, m_, n_ in batches:
            plain = ragged_plain(bname, V.viterbi_forward_full_plain, want,
                                 (x_, m_, n_, p))
            r = full_plane_check(name, x_, m_, n_, p, (x_, m_, n_), plain)
            if int(r["end"].any(1).sum()) != int("capped" in bname):
                fail("phase 14, %s, ragged %s W=%d: walks lost"
                     % (name, bname, W_REALIGN))
        print("phase 14, %s, ragged W=%d (k_pad %d): K4 full plane "
              "bit-identical, K5 full walk identical on %s"
              % (name, W_REALIGN, rprep["k_pad"],
                 ", ".join(b[0] for b in batches)))
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    shifts = torch.arange(0, 15, 3, device=dev, dtype=torch.int32)
    for W_ in (W, W_REALIGN):
        _, x_, m_, n_ = ragged_batches(dev, W_)[0][0]
        fields = torch.randint(0, 5, (x_.shape[0], x_.shape[1] + 1, W_, 5),
                               generator=gen, device=dev, dtype=torch.int32)
        rand = (fields << shifts).sum(-1).to(torch.int16)
        rstate = torch.randint(0, 5, (x_.shape[0],), generator=gen,
                               device=dev, dtype=torch.int32)
        ops_k, end_k = viterbi_walk(rand, x_, m_, n_, rstate)
        ops_p, end_p = viterbi_walk_plain(rand, x_, m_, n_, rstate)
        if not (torch.equal(ops_k, ops_p) and torch.equal(end_k, end_p)):
            fail("phase 14: the full-plane walk differs from the plain walker "
                 "on a random plane at W=%d" % W_)
        print("phase 14, random full plane, ragged B7 W=%d: K5 full walk ops "
              "and end cells identical; walks short of the origin %d"
              % (W_, int(end_k.any(1).sum())))
    print("phase 14 ragged and random batches: %.1f s wall"
          % (time.perf_counter() - t0))

    # ---- MappingEngine with a non-canonical model, card against CPU ----
    wdir = os.path.join(os.path.dirname(fq), "full_plane")
    os.makedirs(wdir, exist_ok=True)
    fq32 = os.path.join(wdir, "reads.fq")
    with open(fq) as src, open(fq32, "w") as dst:
        for _ in range(4 * FULL_ENGINE_READS):
            dst.write(src.readline())
    base = PairHmmModel.default()
    t = np.array(base.transitions, np.float64)
    t[1, 2] = 0.05
    t[1] /= t[1].sum()
    model = PairHmmModel(t, np.array(base.emissions, np.float64))
    cfg = dataclasses.replace(MAPPER_REGISTRY["Viterbi"].config,
                              batch_size=2 * FULL_ENGINE_READS)
    ref = read_fasta_dict(fa)
    sams = {}
    for where in ("cuda", "cpu"):
        eng = MappingEngine(ref, cfg, model=model, index=engine.index,
                            device=dev if where == "cuda" else "cpu")
        if V.viterbi_structure_ok(eng.params):
            fail("phase 14: the engine's model is canonical")
        sams[where] = os.path.join(wdir, where + ".sam")
        if where == "cuda":
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
        t0 = time.perf_counter()
        eng.map_fastq(fq32, sams[where])
        if where == "cuda":
            torch.cuda.synchronize()
            run = {c.name: c.count for c in counters}
        print("phase 14: MappingEngine(model=t[1->2] = 0.05, "
              "decode=\"viterbi\") on %d reads, %s: %.3f s"
              % (FULL_ENGINE_READS, where, time.perf_counter() - t0))

    got, want = engine_records(sams["cuda"]), engine_records(sams["cpu"])
    share = sum(1 for r in got if not r[1] & 0x904 and bool(r[1] & 0x10) == bool(
        int(r[0].split("_")[2])) and abs(r[3] - int(r[0].split("_")[1])) <= 100)
    print("phase 14: %d records on the card, %s the CPU's; primaries at their "
          "origin %d of %d; launches %s"
          % (len(got), "equal to" if got == want else "DIFFERENT from", share,
             FULL_ENGINE_READS, run))
    if got != want or not got:
        fail("phase 14: the engine's records on the card differ from the CPU's")
    if min(run[k] for k in ("pack", "viterbi_full",
                            "viterbi_traceback_full")) <= 0 or any(
            v for k, v in run.items()
            if k not in ("pack", "viterbi_full", "viterbi_traceback_full")):
        fail("phase 14 launches %s: want pack and the full-plane Viterbi and "
             "walker > 0, the rest 0" % run)
    print("phase 14 wall: %.1f s" % (time.perf_counter() - t_phase))
    return run


# ---- phase 15: band widths 65 to 128 in the W = 128 kernels (MEA path) ---- #

def viterbi_path_attributes(width: int, tag: str | None = None) -> dict:
    """Print the registers, local-memory (spill) bytes, static and
    dynamic shared memory and threads and reads a block at band width
    ``width`` of the Viterbi kernel's three steps, the forward-only
    kernel's two gap sums and the Viterbi walker on both planes; returns
    them under ``*<tag>`` (by default ``*_w<width>``) by kernel."""
    from nanopore_tpu_torch.ops import forward, traceback, viterbi

    tag = "_w%d" % width if tag is None else tag

    builds = [("viterbi %s step" % what, name, sfx,
               viterbi.kernel_attributes(width, step))
              for step, what, name, sfx in (
                  (viterbi.SHORT, "short", "viterbi", ""),
                  (viterbi.FIVE_WAY, "5-way", "viterbi", "_5way"),
                  (viterbi.FULL, "full-plane", "viterbi_full", ""))]
    builds += [("forward %s sum" % ("two-term" if two else "5-way"),
                "forward", sfx, forward.kernel_attributes(width, two))
               for two, sfx in ((True, ""), (False, "_5way"))]
    builds += [("viterbi walker, %s plane" % what, name, "",
                traceback.viterbi_walker_attributes(width, full))
               for full, what, name in (
                   (False, "byte", "viterbi_traceback"),
                   (True, "full", "viterbi_traceback_full"))]
    attrs = {}
    for what, name, sfx, a in builds:
        print("%s W=%d: %d registers, %d bytes of local memory (spills) a "
              "thread, %d + %d bytes of static + dynamic shared memory a "
              "block of %d threads and %d read(s)"
              % (what, width, a["registers"], a["local_bytes"],
                 a["static_smem"], a["dynamic_smem"], a["threads"],
                 a["reads"]))
        attrs.setdefault(name, {}).update({
            "registers" + sfx + tag: a["registers"],
            "local_bytes" + sfx + tag: a["local_bytes"],
            "smem_block" + tag: a["static_smem"] + a["dynamic_smem"],
            "warps_per_read" + tag: a["threads"] // 32 // a["reads"],
            "reads_per_block" + tag: a["reads"],
        })
    return attrs


def mea_path_attributes(width: int) -> dict:
    """Print the registers, local-memory (spill) bytes, shared memory a
    block and warps a read of the MEA path's kernels at band width
    ``width`` (each realign mode, the pack, the walkers' shared memory);
    returns them under ``*_w<width>`` by kernel."""
    from nanopore_tpu_torch.ops import pack, realign, traceback

    tag = "_w%d" % width
    attrs = {}
    for mode, a in realign.kernel_attributes(width).items():
        blocks = a["cluster_blocks"]
        print("realign %s W=%d: %d registers, %d bytes of local memory "
              "(spills) a thread, %d + %d bytes of static + dynamic shared "
              "memory a block of %d threads and %d read(s)%s"
              % (mode, width, a["registers"], a["local_bytes"],
                 a["static_smem"], a["dynamic_smem"], a["threads"],
                 a["reads"], "" if a["clusters"] is None else
                 "; a read a cluster of %d blocks, %d clusters resident at "
                 "once" % (blocks, a["clusters"])))
        attrs["realign" if mode == "decode" else "realign_" + mode] = {
            "registers" + tag: a["registers"],
            "local_bytes" + tag: a["local_bytes"],
            "smem_block" + tag: a["static_smem"] + a["dynamic_smem"],
            "warps_per_read" + tag: a["threads"] // 32 // a["reads"]
            * blocks,
        }
        if a["clusters"] is not None:
            attrs["realign" if mode == "decode" else "realign_" + mode][
                "clusters_resident" + tag] = a["clusters"]
    a = pack.kernel_attributes(width)
    print("pack W=%d: %d registers, %d bytes of local memory a thread, %d "
          "bytes of static shared memory a block of %d threads (one read)"
          % (width, a["registers"], a["local_bytes"], a["static_smem"],
             a["threads"]))
    attrs["pack"] = {"registers" + tag: a["registers"],
                     "local_bytes" + tag: a["local_bytes"],
                     "smem_block" + tag: a["static_smem"],
                     "warps_per_read" + tag: a["threads"] // 32}
    smem = traceback.walker_shared_memory(width)
    print("walkers W=%d: dynamic shared memory a block %s" % (width, smem))
    for name, b in smem.items():
        attrs[name] = {"smem_block" + tag: b}
    return attrs


def widths_attributes(widths, paths) -> dict:
    """The attributes of each path's builds at each band width of
    ``widths`` (``paths``: :func:`mea_path_attributes`,
    :func:`viterbi_path_attributes` or both) under ``*_w<width>`` by
    kernel."""
    attrs = {}
    for width in widths:
        for path_attributes in paths:
            for name, a in path_attributes(width).items():
                attrs.setdefault(name, {}).update(a)
    return attrs


def mapping_batch_checks(pairs, params, dev, res: dict, width: int,
                         plain_reads: int, phase: str,
                         viterbi: bool = False, mea: bool = True,
                         pack_plain_all: bool = True) -> None:
    """K1, K2 decode and K3 at W = ``width`` on the mapping main path's
    batch (its 512 reads as a band of all ``width`` lanes, the diagonal
    count the engine gives it), each against its plain version to the
    bars of step 3: the pack (on the first ``plain_reads`` without
    ``pack_plain_all``) and the walker on every read, every walk from
    the origin to the read's end cell, the decode on the first
    ``plain_reads`` at the full diagonal count (a read's outputs do not
    depend on its batch), in its workspace plan's launches; with
    ``viterbi``, then the Viterbi path's kernels
    (:func:`wide_viterbi_checks`, its plain versions on the first
    ``plain_reads``); with ``mea=False`` those alone (on the pack's
    codes); each timed on the whole batch, into ``res[kernel]`` under
    ``*_w<width>``."""
    import torch

    from nanopore_tpu_torch.ops.dispatch import _pairs_k_max
    from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc

    t0 = time.perf_counter()
    tag = "_w%d" % width
    prep = pack_stream_pairs(pairs, width, _pairs_k_max(pairs, None))
    B, k_pad, P = prep["B"], prep["k_pad"], plain_reads
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    m, n = put(prep["m"]), put(prep["n"])
    stream, initx = put(prep["stream"]), put(prep["initx"])
    rows = {}

    def row(name, ms, plain_ms, plain_reads, err, bound, by, per_batch,
            sfx=""):
        t = sfx + tag
        rows.setdefault(name, {}).update({
            "ms" + t: ms, "plain_ms" + t: plain_ms,
            "plain_reads" + t: plain_reads, "max_abs_err" + t: err,
            "bound_ms" + t: bound, "bound_by" + t: by,
            "per_batch" + t: per_batch, "reads" + tag: B, "k_pad" + tag: k_pad})
        print("  %s%s W=%d: %.3f ms per batch of %d in %d launch(es), bound "
              "%.4f ms (%s), plain %.1f ms on %d reads, max abs err %.3g"
              % (name, sfx, width, ms, B, per_batch, bound, by, plain_ms,
                 plain_reads, err))

    print("%s, the mapping batch at W = %d: B=%d k_pad=%d"
          % (phase, width, B, k_pad))
    xyc = pack_xyc(stream, initx, m, n)
    if mea:
        mea_batch_checks(xyc, m, n, stream, initx, prep, params, row, width,
                         P, phase, B if pack_plain_all else P)
    if viterbi:
        wide_viterbi_checks(xyc, m, n, prep, params, row, width, P, phase)
    del xyc
    torch.cuda.empty_cache()  # the other processes on the card share it
    for name, r in rows.items():
        res.setdefault(name, {}).update(r)
    print("%s, the mapping batch: %.1f s" % (phase, time.perf_counter() - t0))


def mea_batch_checks(xyc, m, n, stream, initx, prep, params, row,
                     width: int, P: int, phase: str, PK: int) -> None:
    """The MEA path's rows of :func:`mapping_batch_checks`: K1 on the
    first ``PK`` reads, K2 decode on the first ``P``, K3 on every read,
    each walk from the origin to the read's end cell (m read and n
    reference bases consumed)."""
    import torch

    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.ops import realign
    from nanopore_tpu_torch.ops.pack import pack_xyc, pack_xyc_plain
    from nanopore_tpu_torch.ops.traceback import (
        mea_walk,
        mea_walk_plain,
        rle_ops_batch,
    )

    cfg = MAPPER_REGISTRY["LastParams"].config
    gg, mg = cfg.gap_gamma, cfg.match_gamma
    B, k_pad = xyc.shape[:2]
    kend = prep["k_end"]
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    xyc_p, plain_ms = timed(lambda: pack_xyc_plain(
        stream[:PK], initx[:PK], m[:PK], n[:PK]))
    if not torch.equal(xyc[:PK], xyc_p):
        fail("pack kernel at W=%d differs from its plain version" % width)
    del xyc_p
    row("pack", cuda_ms(lambda: pack_xyc(stream, initx, m, n), 10), plain_ms,
        PK, 0.0, (B * k_pad + B * width + 8 * B + B * k_pad * width)
        / HBM_BYTES_PER_S * 1e3, "bytes", 1)

    # timed first, then the counted call whose outputs are kept: so the
    # direction codes (B x k_pad x W bytes, 10.7 GB at 2048) are held once
    ms = cuda_ms(lambda: realign.realign_decode(
        xyc, m, n, params, gg, mg, kend=kend), 3)
    out_k = {}
    per_batch = launches_per_call(
        realign.LAUNCHES, lambda: out_k.update(realign.realign_decode(
            xyc, m, n, params, gg, mg, kend=kend)))
    out_p, plain_ms = timed(lambda: realign.realign_decode_plain(
        xyc[:P], m[:P], n[:P], params, gg, mg))
    for key in ("loglik", "score"):
        if not bool(torch.isfinite(out_k[key]).all()):
            fail("non-finite realign %s at W=%d" % (key, width))
    ll_rel = rel_err(out_k["loglik"][:P], out_p["loglik"])
    sc_rel = rel_err(out_k["score"][:P], out_p["score"])
    err = float(torch.maximum(
        (out_k["loglik"][:P] - out_p["loglik"]).abs().max(),
        (out_k["score"][:P] - out_p["score"]).abs().max()))
    dirs = out_k["dirs"]
    dirs_rows = int((dirs[:P] != out_p["dirs"]).flatten(1).any(1).sum())
    ops_k = mea_walk(dirs, xyc, m, n)
    cig_k = rle_ops_batch(ops_k[:P].cpu().numpy())
    cig_p = rle_ops_batch(mea_walk(out_p["dirs"], xyc[:P], m[:P], n[:P])
                          .cpu().numpy())
    cig_diff = sum(a != b for a, b in zip(cig_k, cig_p))
    del out_p
    print("  realign W=%d: loglik max rel %.3g, score max rel %.3g, reads "
          "with differing direction codes %d, with differing cigars %d of %d"
          % (width, ll_rel, sc_rel, dirs_rows, cig_diff, P))
    if ll_rel > 1e-5 or sc_rel > 1e-4 or cig_diff > 0.01 * P:
        fail("realign kernel at W=%d outside tolerance" % width)
    plan = realign.workspace_plan(kend, 0, width, mode=realign.DECODE)[1]
    print("  realign W=%d: %d launches, the workspace plan's %d"
          % (width, per_batch, len(plan)))
    if per_batch != len(plan):
        fail("the decode at W=%d took %d launches, its plan %d"
             % (width, per_batch, len(plan)))
    bound, by = realign_bound(
        REALIGN_OPS_PER_CELL, width, need,
        B * k_pad * width + B * (k_pad + 1) * width + 16 * B)
    row("realign", ms, plain_ms, P, err, bound, by, per_batch)

    ops_p, plain_ms = timed(lambda: mea_walk_plain(dirs, xyc, m, n))
    if not torch.equal(ops_k, ops_p):
        fail("walker kernel at W=%d differs from its plain version" % width)
    ops_np = ops_k.cpu().numpy()
    read_bases = ((ops_np == 0) | (ops_np == 2)).sum(1)  # match, insert
    ref_bases = ((ops_np == 0) | (ops_np == 1)).sum(1)   # match, delete
    ends = int(((read_bases == prep["m"]) & (ref_bases == prep["n"])).sum())
    print("  traceback W=%d: ops identical on %d reads, %d walks from the "
          "origin to the read's end cell" % (width, B, ends))
    if ends != B:
        fail("%d of %d MEA walks at W=%d end short of their read's end cell"
             % (B - ends, B, width))
    nbytes = walked_bytes(ops_k) + need - B + B * (k_pad + 1) + 8 * B
    row("traceback", cuda_ms(lambda: mea_walk(dirs, xyc, m, n), 10), plain_ms,
        B, 0.0, nbytes / HBM_BYTES_PER_S * 1e3, "bytes", 1)
    del out_k, dirs, ops_k, ops_p


def wide_viterbi_checks(xyc, m, n, prep, params, row, width: int, P: int,
                        phase: str) -> None:
    """K4 (short and 5-way steps), K4-full (under phase 14's first
    model), K5 on each plane and K6 (both gap sums) at W = ``width`` on
    the mapping batch ``xyc``, each against its plain version: the
    Viterbi's score, fstate and whole plane bit for bit on the first
    ``P`` reads, the walks' ops and end cells on every read, the loglik
    bit-identical (1e-5 relative the bar) on the first ``P``; each
    timed on the whole batch beside its bound, through ``row``."""
    import torch

    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops import traceback as T
    from nanopore_tpu_torch.ops import viterbi as V
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables

    t0 = time.perf_counter()
    B, k_pad = xyc.shape[:2]
    K1 = k_pad + 1
    need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    xs, ms_, ns = (t[:P].contiguous() for t in (xyc, m, n))
    full_p = next(iter(full_plane_models(params).values()))
    byte = V.viterbi_tables(params)
    if not V.short_step(byte) or V.viterbi_structure_ok(full_p):
        fail(phase + ": the models do not take the steps checked")

    def held(what, out_k, want):
        differ = [key for key in want
                  if not bits_equal(out_k[key][:P], want[key])]
        if differ:
            fail(phase + ": %s at W=%d differs from its plain version in %s"
                 % (what, width, differ))

    # K4, its two steps against one plain run (both give its bytes)
    want, plain_ms = timed(lambda: V.viterbi_forward_plain(xs, ms_, ns, params))
    steps = {}
    for step, sfx, ops in ((V.SHORT, "", VITERBI_SHORT_OPS_PER_CELL),
                           (V.FIVE_WAY, "_5way", VITERBI_OPS_PER_CELL)):
        out = V._launch(xyc, m, n, byte, step)
        held("K4 (%s step)" % ("short" if step == V.SHORT else "5-way"), out,
             want)
        steps[step] = out
        bound, by = realign_bound(ops, width, need,
                                  (need - B) * width + B * K1 * width
                                  + 12 * B)
        row("viterbi", cuda_ms(lambda: V._launch(xyc, m, n, byte, step), 3),
            plain_ms, P, 0.0, bound, by, 1, sfx)
    if not all(torch.equal(steps[V.SHORT][key], steps[V.FIVE_WAY][key])
               for key in want):
        fail(phase + ": K4's two steps differ at W=%d" % width)
    print("  viterbi W=%d: both steps' score, fstate and whole plane "
          "bit-identical to the plain version's on %d reads"
          % (width, P))
    del want, steps[V.FIVE_WAY]
    out_b = steps.pop(V.SHORT)
    # K4-full, timed before its plane is held (10.7 GB at W = 1024)
    want, plain_ms = timed(lambda: V.viterbi_forward_full_plain(
        xs, ms_, ns, full_p))
    ms = cuda_ms(lambda: V.viterbi_forward(xyc, m, n, full_p), 3)
    out_f = V.viterbi_forward(xyc, m, n, full_p)
    if out_f["bp"].dtype != torch.int16:
        fail(phase + ": the Viterbi did not take the full plane")
    held("K4-full", out_f, want)
    del want
    bound, by = realign_bound(VITERBI_OPS_PER_CELL, width, need,
                              (need - B) * width + B * K1 * width * 2
                              + 12 * B)
    row("viterbi_full", ms, plain_ms, P, 0.0, bound, by, 1)
    print("  viterbi_full W=%d: score, fstate and whole int16 plane "
          "bit-identical on %d reads" % (width, P))
    # K5 on each plane, every read
    for name, out, per_step in (("viterbi_traceback", out_b, 1),
                                ("viterbi_traceback_full", out_f, 2)):
        args = (out["bp"], xyc, m, n, out["fstate"])
        (ops_k, end_k) = T.viterbi_walk(*args)
        (ops_p, end_p), plain_ms = timed(lambda: T.viterbi_walk_plain(*args))
        if not (torch.equal(ops_k, ops_p) and torch.equal(end_k, end_p)):
            fail(phase + ": %s at W=%d differs from the plain walker"
                 % (name, width))
        lost = int(end_k.any(1).sum())
        print("  %s W=%d: ops and end cells identical on %d reads; walks "
              "short of the origin %d" % (name, width, B, lost))
        if lost:
            fail(phase + ": %d %s walks stop short" % (lost, name))
        nbytes = (per_step * walked_bytes(ops_k) + need - B + B * K1
                  + 20 * B)
        row(name, cuda_ms(lambda: T.viterbi_walk(*args), 10), plain_ms, B,
            0.0, nbytes / HBM_BYTES_PER_S * 1e3, "bytes", 1)
        del ops_k, ops_p
    del out_b, out_f
    # K6, its two gap sums against one plain run
    ll_p, plain_ms = timed(lambda: F.forward_loglik_plain(xs, ms_, ns, params))
    tab = kernel_tables(params)
    if not F.two_term_sum(tab):
        fail(phase + ": the default model does not take the two-term sum")
    for two, sfx, ops in ((True, "", FORWARD_SHORT_OPS_PER_CELL),
                          (False, "_5way", FORWARD_OPS_PER_CELL)):
        ll_k = F._launch(xyc, m, n, tab, two)["loglik"]
        if not bool(torch.isfinite(ll_k).all()):
            fail(phase + ": non-finite forward loglik at W=%d" % width)
        ll_rel = rel_err(ll_k[:P], ll_p)
        same = bits_equal(ll_k[:P], ll_p)
        print("  forward (%s sum) W=%d: loglik max rel %.3g (%s) on %d reads"
              % ("two-term" if two else "5-way", width, ll_rel,
                 "bit-identical" if same else "not bit-identical", P))
        if ll_rel > 1e-5:
            fail(phase + ": forward kernel at W=%d outside tolerance"
                 % width)
        bound, by = realign_bound(ops, width, need,
                                  (need - B) * width + 16 * B)
        row("forward", cuda_ms(lambda: F._launch(xyc, m, n, tab, two), 3),
            plain_ms, P, float((ll_k[:P] - ll_p).abs().max()), bound, by, 1,
            sfx)
    print("%s, the Viterbi path on the mapping batch: %.1f s"
          % (phase, time.perf_counter() - t0))


def engine_records(path: str) -> list:
    """A SAM's records as the engine checks compare them (with AS)."""
    from nanopore_tpu_torch.io.sam import SamReader

    return [(r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.seq,
             dict((tg[0], tg[2]) for tg in r.tags).get("AS"))
            for r in SamReader(path)]


MEA_KERNELS = ("pack", "realign", "traceback")
VITERBI_KERNELS = ("pack", "viterbi", "viterbi_traceback")


def only_launched(run: dict, want, what: str) -> None:
    """Fail unless each kernel of ``want`` launched in ``run`` and no
    other did."""
    if min(run[k] for k in want) <= 0 or any(
            v for k, v in run.items() if k not in want):
        fail("%s launches %s: want %s > 0, the rest 0"
             % (what, run, ", ".join(want)))


def engine_name(cfg) -> str:
    return "MappingEngine(band_width=%d%s)" % (
        cfg.band_width, "" if cfg.decode == "mea" else ', decode="viterbi"')


def warm_engine_run(ref, cfg, engine, fq: str, sam: str, dev, counters,
                    phase: str, want) -> dict:
    """``MappingEngine(cfg)`` (``engine``'s index) on the mapping workload
    ``fq``, cold then warm, every counter set to 0 before the warm run:
    >= 99 % of primaries at their origin, the kernels ``want`` launched
    and no other.  Returns the warm run's launches."""
    import torch

    from nanopore_tpu_torch.mapping.engine import MappingEngine

    eng = MappingEngine(ref, cfg, index=engine.index, device=dev)
    eng.map_fastq(fq, sam)  # cold
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    eng.map_fastq(fq, sam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {c.name: c.count for c in counters}
    share = origin_share(sam)
    print("%s: %s on %d reads: %.3f s warm = %.1f reads/s; primaries at "
          "origin %.4f; launches %s" % (phase, engine_name(cfg), N_READS,
                                        wall, N_READS / wall, share, run))
    if share < 0.99:
        fail("%s: only %.4f of %s's primaries at their origin"
             % (phase, share, engine_name(cfg)))
    only_launched(run, want, "%s %s" % (phase, engine_name(cfg)))
    return run


def engine_run(ref, cfg, fq: str, wdir: str, device, index=None) -> str:
    """``MappingEngine(cfg)`` (``index``: another engine's, else its own)
    on the first WIDE_ENGINE_READS reads of ``fq``, in one batch, on
    ``device``; returns the SAM it wrote in ``wdir``."""
    import dataclasses

    from nanopore_tpu_torch.mapping.engine import MappingEngine

    fq32 = os.path.join(wdir, "reads.fq")
    with open(fq) as src, open(fq32, "w") as dst:
        for _ in range(4 * WIDE_ENGINE_READS):
            dst.write(src.readline())
    cfg = dataclasses.replace(cfg, batch_size=2 * WIDE_ENGINE_READS)
    sam = os.path.join(wdir, "%s_w%d_%s.sam" % (
        cfg.decode, cfg.band_width, "cpu" if device == "cpu" else "cuda"))
    MappingEngine(ref, cfg, index=index, device=device).map_fastq(fq32, sam)
    return sam


def engine_card_vs_cpu(ref, cfg, engine, fq: str, wdir: str, dev, counters,
                       phase: str, want) -> dict:
    """:func:`engine_run` on the card (``engine``'s index, every counter
    set to 0 just before) against its run with ``device="cpu"`` (by the
    CPU halves' process): records equal, the kernels ``want`` launched
    and no other.  Returns the card run's launches."""
    import torch

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    sam = engine_run(ref, cfg, fq, wdir, dev, engine.index)
    torch.cuda.synchronize()
    run = {c.name: c.count for c in counters}
    print("%s: %s on %d reads on the card: %.3f s"
          % (phase, engine_name(cfg), WIDE_ENGINE_READS,
             time.perf_counter() - t0))
    half = cpu_half(half_key("engine", cfg.band_width, cfg.decode))
    print("%s: %s on %d reads on the CPU: %.1f s"
          % (phase, engine_name(cfg), WIDE_ENGINE_READS, half["wall"]))
    got, want_recs = engine_records(sam), engine_records(half["path"])
    print("%s: %d records of %s on the card, %s the CPU's; launches %s"
          % (phase, len(got), engine_name(cfg),
             "equal to" if got == want_recs else "DIFFERENT from", run))
    if got != want_recs or not got:
        fail("%s: %s's records on the card differ from the CPU's"
             % (phase, engine_name(cfg)))
    only_launched(run, want, "%s %s" % (phase, engine_name(cfg)))
    return run


def wide_phase(engine, pairs, fa: str, fq: str, wl: dict, dev, counters
               ) -> dict:
    """Phase 15 (its checks in the docstring's step 15): the W = 128
    kernels on the mapping batch and at live width 96 on phase 13's
    reads, the engine at W = 128, ``realign`` and EM at 96 card against
    CPU, and the Viterbi engine at 96 card against CPU and at 128.
    Returns the kernels' ``*_w128`` and ``*_w96`` numbers and each run's
    launches."""
    import dataclasses

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    mapping_batch_checks(pairs, engine.params, dev, res, WIDE_W, PLAIN_READS,
                         "phase 15", viterbi=True)
    wdir = os.path.join(os.path.dirname(fq), "wide")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    cfg = dataclasses.replace(engine.config, band_width=WIDE_W)
    if cfg.decode != "mea":
        fail("phase 15: the engine does not take the MEA decode")
    runs["wide_map"] = warm_engine_run(
        ref, cfg, engine, fq, os.path.join(wdir, "map_w128.sam"), dev,
        counters, "phase 15", MEA_KERNELS)
    runs["wide_engine"] = engine_card_vs_cpu(
        ref, cfg, engine, fq, wdir, dev, counters, "phase 15", MEA_KERNELS)

    # ---- live width 96 in W = 128 on phase 13's reads ----
    width_kernel_checks(wl["pairs"], WIDE_LIVE, dev, res, "phase 15")
    runs["wide_realign"] = realign_cli_check(wl, WIDE_LIVE, counters,
                                             "phase 15")
    runs["wide_em"] = em_width_check(wl, WIDE_LIVE, dev, counters, "phase 15")

    # ---- the Viterbi engine at 96 on 32 reads and at 128 ----
    vit = dataclasses.replace(cfg, decode="viterbi")
    runs["wide_viterbi_engine"] = engine_card_vs_cpu(
        ref, dataclasses.replace(vit, band_width=WIDE_LIVE), engine, fq,
        wdir, dev, counters, "phase 15", VITERBI_KERNELS)
    runs["wide_viterbi_map"] = warm_engine_run(
        ref, vit, engine, fq, os.path.join(wdir, "viterbi_w128.sam"), dev,
        counters, "phase 15", VITERBI_KERNELS)
    print("phase 15 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


def wide_alone() -> int:
    """Run as ``chip_smoke.py --wide``: the kernels' build and the
    W = 128 attributes, then phase 15 alone (with the mapping workload
    and phase 13's reads it takes)."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.kernels import build
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print("build: %.1f s" % build.build())
    attrs = widths_attributes((WIDE_W,), (mea_path_attributes,
                                          viterbi_path_attributes))
    dev = torch.device("cuda", 0)
    cpu = start_cpu_halves([(15,)], dev)
    workdir = os.path.join(build.BUILD_DIR, "smoke", "wide_alone")
    fa, fq = write_workload(workdir, REF_LEN)
    engine = MappingEngine(read_fasta_dict(fa),
                           MAPPER_REGISTRY["LastParams"].config, device=dev)
    pairs = main_path_batch(engine, fq, preferred_realign_batch_size(None, dev))
    wl = width_workload(workdir, dev)
    out = wide_phase(engine, pairs, fa, fq, wl, dev, launch_counters())
    finish_cpu_halves(cpu)
    for name, a in attrs.items():
        out["res"].setdefault(name, {}).update(a)
    print(card)
    print(json.dumps(out))
    return 0


def wider_phase(engine, pairs, fa: str, fq: str, wl: dict, dev, counters
                ) -> dict:
    """Phase 16 (its checks in the docstring's step 16): the W = 256
    builds on the mapping batch and at live widths 200 and 256 on phase
    13's reads, the engine at W = 256, the engine, ``realign`` and EM at
    200 card against CPU, and the refusals of :func:`refusal_check`.
    Returns the kernels' ``*_w256``, ``*_w200`` and ``*_live256`` numbers
    and each run's launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    mapping_batch_checks(pairs, engine.params, dev, res, WIDER_W,
                         WIDER_PLAIN_READS, "phase 16")
    wdir = os.path.join(os.path.dirname(fq), "wider")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    cfg = dataclasses.replace(engine.config, band_width=WIDER_W)
    if cfg.decode != "mea":
        fail("phase 16: the engine does not take the MEA decode")
    runs["wider_map"] = warm_engine_run(
        ref, cfg, engine, fq, os.path.join(wdir, "map_w256.sam"), dev,
        counters, "phase 16", MEA_KERNELS)
    torch.cuda.empty_cache()

    # ---- live widths 200 and 256 on phase 13's reads ----
    for w in (WIDER_LIVE, WIDER_W):
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 16",
                            viterbi=False)

    # ---- the engine, realign and EM at 200, card against CPU ----
    live = dataclasses.replace(cfg, band_width=WIDER_LIVE)
    runs["wider_engine"] = engine_card_vs_cpu(
        ref, live, engine, fq, wdir, dev, counters, "phase 16", MEA_KERNELS)
    runs["wider_realign"] = realign_cli_check(wl, WIDER_LIVE, counters,
                                              "phase 16")
    runs["wider_em"] = em_width_check(wl, WIDER_LIVE, dev, counters,
                                      "phase 16")

    refusal_check(ref, cfg, engine, pairs, dev, "phase 16")
    print("phase 16 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


def refusal_check(ref, cfg, engine, pairs, dev, phase: str) -> None:
    """On the card the MEA path (``MappingEngine`` with the MEA decode,
    ``PreparedRealign``) refuses 2049 and the Viterbi path
    (``MappingEngine(decode="viterbi")``, ``PreparedViterbi``,
    ``PreparedForward``) 1025, each naming C11 before any work (the rest
    of C11)."""
    import dataclasses

    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.ops.dispatch import (
        PreparedForward,
        PreparedRealign,
        PreparedViterbi,
        prepared_from_pairs,
    )

    calls = {}
    tops = {"mea": W2048[-1] + 1, "viterbi": W1024[-1] + 1}
    for d, w in tops.items():
        c = dataclasses.replace(cfg, band_width=w, decode=d)
        calls[engine_name(c)] = (w, lambda c=c: MappingEngine(
            ref, c, index=engine.index, device=dev))
    for cls in (PreparedRealign, PreparedViterbi, PreparedForward):
        w = tops["mea" if cls is PreparedRealign else "viterbi"]
        calls["%s at %d" % (cls.__name__, w)] = (
            w, lambda cls=cls: prepared_from_pairs(
                {"device": dev}, pairs[:2], engine.params, band_width=w,
                prepared_cls=cls))
    for what, (w, call) in calls.items():
        try:
            call()
        except ValueError as err:
            print("%s: %s on the card: %s" % (phase, what, err))
            if "C11" not in str(err):
                fail("%s: the refusal of %s does not name C11" % (phase, what))
        else:
            fail("%s: %s took band width %d on the card" % (phase, what, w))


def wider_workloads(workdir: str, dev):
    """Phase 16's own copies of the seeded mapping workload (engine, main
    path batch) and of phase 13's reads, under ``workdir``."""
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size

    fa, fq = write_workload(workdir, REF_LEN)
    engine = MappingEngine(read_fasta_dict(fa),
                           MAPPER_REGISTRY["LastParams"].config, device=dev)
    pairs = main_path_batch(engine, fq, preferred_realign_batch_size(None, dev))
    return engine, pairs, fa, fq, width_workload(workdir, dev)


# ---- phase 18: band widths 257 to 512 in the W = 384 and 512 kernels ---- #

def widest_phase(engine, pairs, fa: str, fq: str, wl: dict, dev,
                 counters) -> dict:
    """Phase 18 (its checks in the docstring's step 18): the W = 512
    builds on the mapping batch, the engine at W = 512, the W = 384 and
    512 builds at the live ``widths`` (of 300, 384, 450 and 512) on phase
    13's reads, the engine, ``realign`` and EM at 450 card against CPU,
    and the refusals of :func:`refusal_check`.  Returns the kernels'
    ``*_w512`` (the mapping batch) and live widths' (``*_w300``,
    ``*_live384``, ...) numbers and each run's launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    top = WIDEST_W[-1]
    mapping_batch_checks(pairs, engine.params, dev, res, top,
                         WIDEST_PLAIN_READS, "phase 18")
    wdir = os.path.join(os.path.dirname(fq), "widest")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    cfg = dataclasses.replace(engine.config, band_width=top)
    if cfg.decode != "mea":
        fail("phase 18: the engine does not take the MEA decode")
    runs["widest_map"] = warm_engine_run(
        ref, cfg, engine, fq, os.path.join(wdir, "map_w%d.sam" % top), dev,
        counters, "phase 18", MEA_KERNELS)
    torch.cuda.empty_cache()

    # ---- live widths of 300, 384, 450 and 512 on phase 13's reads ----
    for w in WIDEST_LIVE:
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 18",
                            viterbi=False)

    # ---- the engine, realign and EM at 450, card against CPU ----
    live = dataclasses.replace(cfg, band_width=WIDEST_CPU)
    runs["widest_engine"] = engine_card_vs_cpu(
        ref, live, engine, fq, wdir, dev, counters, "phase 18", MEA_KERNELS)
    runs["widest_realign"] = realign_cli_check(wl, WIDEST_CPU, counters,
                                               "phase 18")
    runs["widest_em"] = em_width_check(wl, WIDEST_CPU, dev, counters,
                                       "phase 18")
    refusal_check(ref, cfg, engine, pairs, dev, "phase 18")
    print("phase 18 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


# ---- phase 17: band widths 129 to 256 on the Viterbi path ---- #

# the N's position in each read of the pair vote case, above the live
# width w: w + 100 to w + 280, but at w = 900 (one live lane in the top
# warp of 1024 lanes) where the N enters that lane in the last few
# diagonals of a chunk of 64, before the NaN spreads into the warp below
PAIR_VOTE_AT = {900: (122, 154, 186, 218, 250)}


def pair_vote_case(params, w: int = WIDER_LIVE):
    """Reads of w + 300 bases against their windows (8 % substitutions),
    each but the last with one N in its window at a position (w + 100 to
    w + 280, :data:`PAIR_VOTE_AT`) where it enters the live band of width
    w at its top, and ``params`` with the first delete state's emission
    of an N set to NaN: that state turns NaN at the N's cell, in the top
    live warp's cells of a band on a group of warps (128-199 at w = 200
    in 256 lanes, 256-299 at 300 in 384, 384-449 at 450 in 512, 512-599
    at 600 in 768, 896-899 at 900 in 1024), and the NaN spreads down
    about half a cell a diagonal, so the chunk of 64 diagonals where the
    two-term sum's check first fails fails in that warp alone
    (:func:`warp_checks`).  The last read keeps a finite loglik."""
    from nanopore_tpu_torch.io.sam import CIG
    from nanopore_tpu_torch.ops.pairhmm import params_from_numpy

    rng = np.random.default_rng(SEED + 17)
    pairs = []
    L = w + 300
    for at in PAIR_VOTE_AT.get(w, (100, 150, 200, 240, 280)) + (None,):
        pos = None if at is None else w + at
        x = rng.integers(0, 4, L).astype(np.int8)
        y = np.where(rng.random(L) < 0.08, rng.integers(0, 4, L),
                     x).astype(np.int8)
        if pos is not None:
            x[pos] = 4
        pairs.append((x, y, [(CIG.M, L)]))
    eg = params.e_gap_flat.cpu().numpy().reshape(5, 5).copy()
    eg[1, 4] = np.nan
    return pairs, params_from_numpy(params.t.cpu().numpy(),
                                    params.e_match_flat.cpu().numpy(),
                                    eg.reshape(-1))


def warp_checks(xyc, m, n, p, chunk: int = 64, cells: int = 128):
    """The forward-only kernel's two-term check (csrc/forward.cu) on each
    warp's cells of a band on a group of warps (``cells`` each), chunk by
    chunk, from a plain two-term recursion: for each read its first
    failing chunk's first diagonal and, warp by warp from the bottom,
    whether its check fails there (every gap state before the rescale
    finite, the band maximum, the group's, in [FLT_MIN, 2^126))."""
    import torch

    from nanopore_tpu_torch.ops.pairhmm import kernel_tables
    from nanopore_tpu_torch.ops.realign import _shift

    B, k_pad, W_ = xyc.shape
    dev = xyc.device
    tab = kernel_tables(p).to(dev)
    tf, emf, egf = tab[:25].reshape(5, 5), tab[25:61], tab[61:91]
    codes = xyc.to(torch.int32) & 0xFF
    base = torch.arange(W_, device=dev) + 1
    a = torch.zeros((B, 5, W_), device=dev)
    a[:, :, 0] = 0.2
    b, rs = torch.zeros_like(a), torch.ones(B, device=dev)
    klast = torch.clamp(m.long() + n.long(), max=k_pad)
    first = [None] * B

    def step(k, prev, pp, r):
        c = codes[:, k - 1]
        x, y = (c >> 3) & 7, c & 7
        e = torch.stack([emf[x * 6 + y], egf[6 + x], egf[12 + y],
                         egf[18 + x], egf[24 + y]], 1)
        d1, d1p = (c[:, 0] >> 6) & 1, (c[:, 0] >> 7) & 1
        t0 = pp[:, 0] * tf[0, 0]
        for s in range(1, 5):
            t0 = t0 + tf[s, 0] * pp[:, s]
        t = torch.stack([t0] + [tf[0, g] * prev[:, 0] + tf[g, g] * prev[:, g]
                                for g in range(1, 5)], 1)
        t = _shift(t, torch.stack([d1 + d1p - 1, d1 - 1, d1, d1 - 1, d1], 1),
                   0.0, base)
        t = torch.cat([(t[:, 0] * r[:, None])[:, None], t[:, 1:]], 1)
        return e * t

    G = -(-W_ // cells)
    for q0 in range(0, k_pad, chunk):
        bad = torch.zeros((B, G), dtype=torch.bool, device=dev)
        for k0 in range(q0, min(q0 + chunk, k_pad), 2):
            nb = step(k0 + 1, a, b, rs)
            na = step(k0 + 2, nb, a, torch.ones_like(rs))
            scale = na.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, torch.ones_like(scale))
            out = ~((safe >= 1.17549435e-38) & (safe < 2.0 ** 126))
            nf = ~torch.isfinite(torch.stack([nb[:, 1:], na[:, 1:]], 1))
            fails = torch.stack([nf[..., g * cells:(g + 1) * cells]
                                 .flatten(1).any(1) for g in range(G)], 1)
            bad |= (fails | out[:, None]) & (k0 < klast)[:, None]
            a, b, rs = na * (1.0 / safe)[:, None, None], nb, 1.0 / safe
        for r, warps in enumerate(bad.tolist()):
            if first[r] is None and any(warps):
                first[r] = (q0 + 1, tuple(warps))
    return first


def forward_pair_vote_check(dev, params, w: int = WIDER_LIVE,
                            phase: str = "phase 17") -> None:
    """K6 at live width ``w`` in its layout (a group of G = W / 128
    warps) on :func:`pair_vote_case`: in each N read the two-term check
    first fails in a chunk where only the top live warp's cells fail it
    (the top warp's but at w = 600 in 768 lanes, whose top warp is all
    dead lanes); the
    group's vote must send the whole read to the 5-way sum from that
    chunk's start (``switched``), and the loglik must be the plain
    version's (NaN where the NaN reaches the end cell, bit for bit where
    finite)."""
    import torch

    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables

    t0 = time.perf_counter()
    pairs, p = pair_vote_case(params, w)
    xyc, m, n, prep, _ = live_batch(pairs, w, dev)
    W_ = xyc.shape[2]
    G = W_ // 128
    tab = kernel_tables(p)
    if not F.two_term_sum(tab) or G < 2:
        fail("%s: the pair vote case does not take the two-term sum on a "
             "group of warps at W = %d" % (phase, W_))
    out = F._launch(xyc, m, n, tab, True)
    ll = F.forward_loglik(xyc, m, n, p)
    want = F.forward_loglik_plain(xyc, m, n, p)
    first = warp_checks(xyc, m, n, p)
    switched = out["switched"].tolist()
    print("K6 forward W=%d, the pair vote case (w = %d, k_pad %d): first "
          "failing chunk (diagonal, each warp's check fails) %s; the "
          "kernel's first 5-way diagonal %s; loglik %s (plain %s)"
          % (W_, w, prep["k_pad"], first, switched, ll.tolist(),
             want.tolist()))
    top = (w - 1) // 128  # the top live warp
    alone = (False,) * top + (True,) + (False,) * (G - 1 - top)
    top_only = [f is not None and f[1] == alone for f in first]
    if top_only != [True] * (len(pairs) - 1) + [False]:
        fail("%s: the pair vote case does not fail the top live warp's "
             "check alone at W = %d" % (phase, W_))
    if switched != [f[0] if f else -1 for f in first]:
        fail("%s: the forward kernel did not send each read to the 5-way "
             "sum at its chunk whose top warp failed (W = %d)" % (phase, W_))
    if not (nan_equal(ll, want) and nan_equal(out["loglik"], want)
            and bool(torch.isfinite(want[-1]))):
        fail("%s: the forward kernel's loglik on the pair vote case "
             "differs from its plain version's at W = %d" % (phase, W_))
    print("K6 forward pair vote case W=%d: loglik the plain version's (%s), "
          "%.1f s" % (W_, "bit-identical" if bits_equal(ll, want)
                      else "NaN where it is NaN", time.perf_counter() - t0))


def forward_finite_switch_check(dev, params, runs=N_RUNS_WIDER,
                                lanes: int = WIDER_W,
                                phase: str = "phase 17") -> None:
    """K6 in ``lanes`` lanes (a group of warps) on :func:`n_run_case`'s
    reads of ``runs`` with N emissions of 1e-37: where the two-term
    check first fails, the band maximum (the group's) is a subnormal
    with a finite inverse, so every warp rolls back a, b, rs, ls and
    acc, reruns the chunk with the 5-way sum across the seams, and ends
    finite.  ``switched`` must be the first failing chunk of
    :func:`warp_checks` for every read, at least three reads must switch
    mid-read, and every loglik must be finite and the plain version's
    bit for bit."""
    import torch

    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops.pairhmm import kernel_tables

    t0 = time.perf_counter()
    pairs, p = n_run_case(params, runs, 1e-37)
    xyc, m, n, _ = device_batch(pairs, lanes, None, dev,
                                "finite switch batch", check_pack=False)
    out = F._launch(xyc, m, n, kernel_tables(p), True)
    ll = F.forward_loglik(xyc, m, n, p)
    want = F.forward_loglik_plain(xyc, m, n, p)
    first = warp_checks(xyc, m, n, p)
    switched = out["switched"].tolist()
    kend = (m + n).tolist()
    print("K6 forward W=%d, the finite switch case: first failing chunk "
          "(diagonal, each warp's check fails) %s; the kernel's first 5-way "
          "diagonal %s of m + n %s; loglik %s (plain %s)"
          % (lanes, first, switched, kend, ll.tolist(), want.tolist()))
    if switched != [f[0] if f else -1 for f in first]:
        fail("%s: the forward kernel's switches on the finite switch case "
             "are not its check's (W = %d)" % (phase, lanes))
    if sum(1 < s < k for s, k in zip(switched, kend)) < 3:
        fail("%s: fewer than three reads of the finite switch case "
             "switched mid-read (W = %d)" % (phase, lanes))
    if not (bits_equal(ll, want) and bits_equal(out["loglik"], want)
            and bool(torch.isfinite(want).all())):
        fail("%s: the forward kernel's loglik on the finite switch case is "
             "not the plain version's finite bits (W = %d)" % (phase, lanes))
    print("K6 forward finite switch case W=%d: every loglik finite and "
          "bit-identical, %.1f s" % (lanes, time.perf_counter() - t0))


def viterbi_wider_phase(engine, pairs, fa: str, fq: str, wl: dict, dev,
                        counters) -> dict:
    """Phase 17 (its checks in the docstring's step 17): the Viterbi
    path's W = 256 builds on the mapping batch and at live widths 200
    and 256 on phase 13's reads, the pair vote case, the Viterbi engine
    at W = 256 and at 200 card against CPU.  Returns the kernels'
    ``*_w256``, ``*_w200`` and ``*_live256`` numbers and each run's
    launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    mapping_batch_checks(pairs, engine.params, dev, res, WIDER_W,
                         WIDER_PLAIN_READS, "phase 17", viterbi=True,
                         mea=False)
    for w in (WIDER_LIVE, WIDER_W):
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 17", mea=False)
    forward_pair_vote_check(dev, engine.params)
    forward_finite_switch_check(dev, engine.params)
    torch.cuda.empty_cache()

    wdir = os.path.join(os.path.dirname(fq), "viterbi_wider")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    vit = dataclasses.replace(engine.config, band_width=WIDER_W,
                              decode="viterbi")
    runs["viterbi_wider_map"] = warm_engine_run(
        ref, vit, engine, fq, os.path.join(wdir, "viterbi_w256.sam"), dev,
        counters, "phase 17", VITERBI_KERNELS)
    runs["viterbi_wider_engine"] = engine_card_vs_cpu(
        ref, dataclasses.replace(vit, band_width=WIDER_LIVE), engine, fq,
        wdir, dev, counters, "phase 17", VITERBI_KERNELS)
    print("phase 17 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


# ---- phase 19: band widths 257 to 512 on the Viterbi path ---- #

def viterbi_widest_phase(engine, pairs, fa: str, fq: str, wl: dict, dev,
                         counters) -> dict:
    """Phase 19 (its checks in the docstring's step 19): the Viterbi
    path's W = 512 builds on the mapping batch ``pairs``, its W = 384
    and 512 builds in every step at live widths 300 and 450 on phase
    13's reads (``wl``), the group vote at 300 and 450 and the finite
    switch in 512 lanes, the Viterbi engine at W = 512 and at 450 card
    against CPU, and the refusals of :func:`refusal_check`.  Returns the
    kernels' ``*_w512`` (the mapping batch), ``*_w300`` and ``*_w450``
    numbers and each run's launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    top = WIDEST_W[-1]
    mapping_batch_checks(pairs, engine.params, dev, res, top,
                         WIDEST_PLAIN_READS, "phase 19", viterbi=True,
                         mea=False)
    # every step at 300 (in 384) and 450 (in 512); the full band of the
    # 512 layout is the mapping batch's, and each row times the full
    # band of its layout too
    for w in WIDEST_DEAD:
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 19", mea=False,
                            every_step=True)
        forward_pair_vote_check(dev, engine.params, w, "phase 19")
    forward_finite_switch_check(dev, engine.params, N_RUNS_WIDEST, top,
                                "phase 19")
    torch.cuda.empty_cache()

    wdir = os.path.join(os.path.dirname(fq), "viterbi_widest")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    vit = dataclasses.replace(engine.config, band_width=top,
                              decode="viterbi")
    runs["viterbi_widest_map"] = warm_engine_run(
        ref, vit, engine, fq, os.path.join(wdir, "viterbi_w%d.sam" % top),
        dev, counters, "phase 19", VITERBI_KERNELS)
    runs["viterbi_widest_engine"] = engine_card_vs_cpu(
        ref, dataclasses.replace(vit, band_width=WIDEST_CPU), engine, fq,
        wdir, dev, counters, "phase 19", VITERBI_KERNELS)
    refusal_check(ref, engine.config, engine, pairs, dev, "phase 19")
    print("phase 19 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


# ---- phase 21: band widths 513 to 1024 in the W = 768 and 1024 kernels ---- #

def w1024_phase(engine, pairs, fa: str, fq: str, wl: dict, dev,
                counters) -> dict:
    """Phase 21 (its checks in the docstring's step 21): the W = 1024
    builds on the mapping batch, the engine at W = 1024, the W = 768 and
    1024 builds at the live widths 600, 768, 900 and 1024 on phase 13's
    reads, the engine, ``realign`` and EM at 900 card against CPU, and
    the refusals of :func:`refusal_check`.  Returns the kernels'
    ``*_w1024`` (the mapping batch) and live widths' (``*_w600``,
    ``*_live768``, ...) numbers and each run's launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    top = W1024[-1]
    mapping_batch_checks(pairs, engine.params, dev, res, top,
                         W1024_PLAIN_READS, "phase 21")
    wdir = os.path.join(os.path.dirname(fq), "w1024")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    cfg = dataclasses.replace(engine.config, band_width=top)
    if cfg.decode != "mea":
        fail("phase 21: the engine does not take the MEA decode")
    runs["w1024_map"] = warm_engine_run(
        ref, cfg, engine, fq, os.path.join(wdir, "map_w%d.sam" % top), dev,
        counters, "phase 21", MEA_KERNELS)
    torch.cuda.empty_cache()

    # ---- live widths of 600, 768, 900 and 1024 on phase 13's reads ----
    for w in W1024_LIVE:
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 21",
                            viterbi=False)

    # ---- the engine, realign and EM at 900, card against CPU ----
    live = dataclasses.replace(cfg, band_width=W1024_CPU)
    runs["w1024_engine"] = engine_card_vs_cpu(
        ref, live, engine, fq, wdir, dev, counters, "phase 21", MEA_KERNELS)
    runs["w1024_realign"] = realign_cli_check(wl, W1024_CPU, counters,
                                              "phase 21")
    runs["w1024_em"] = em_width_check(wl, W1024_CPU, dev, counters,
                                      "phase 21")
    refusal_check(ref, cfg, engine, pairs, dev, "phase 21")
    print("phase 21 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


# ---- phase 22: band widths 513 to 1024 on the Viterbi path ---- #

def viterbi_w1024_phase(engine, pairs, fa: str, fq: str, wl: dict, dev,
                        counters) -> dict:
    """Phase 22 (its checks in the docstring's step 22): the Viterbi
    path's W = 1024 builds on the mapping batch ``pairs``, its W = 768
    and 1024 builds in every step at live widths 600, 768, 900 and 1024
    on phase 13's reads (``wl``), the group vote at 600 and 900 and the
    finite switch in 1024 lanes, the Viterbi engine at W = 1024 and at
    900 card against CPU, and the refusals of :func:`refusal_check`.
    Returns the kernels' ``*_w1024`` (the mapping batch) and live
    widths' (``*_w600``, ``*_live768``, ...) numbers and each run's
    launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    top = W1024[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    mapping_batch_checks(pairs, engine.params, dev, res, top,
                         W1024_PLAIN_READS, "phase 22", viterbi=True,
                         mea=False)
    print("phase 22: peak device memory of this process on the mapping "
          "batch %.3f GB" % (torch.cuda.max_memory_allocated(dev) / 1e9))
    for w in W1024_LIVE:
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 22", mea=False,
                            every_step=True)
    for w in W1024_DEAD:
        forward_pair_vote_check(dev, engine.params, w, "phase 22")
    forward_finite_switch_check(dev, engine.params, N_RUNS_W1024, top,
                                "phase 22")
    torch.cuda.empty_cache()

    wdir = os.path.join(os.path.dirname(fq), "viterbi_w1024")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    vit = dataclasses.replace(engine.config, band_width=top,
                              decode="viterbi")
    runs["viterbi_w1024_map"] = warm_engine_run(
        ref, vit, engine, fq, os.path.join(wdir, "viterbi_w%d.sam" % top),
        dev, counters, "phase 22", VITERBI_KERNELS)
    runs["viterbi_w1024_engine"] = engine_card_vs_cpu(
        ref, dataclasses.replace(vit, band_width=W1024_CPU), engine, fq,
        wdir, dev, counters, "phase 22", VITERBI_KERNELS)
    refusal_check(ref, engine.config, engine, pairs, dev, "phase 22")
    print("phase 22 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


# ---- phase 23: band widths 1025 to 2048 in the W = 1536 and 2048 kernels ---- #

def w2048_phase(engine, pairs, fa: str, fq: str, wl: dict, dev,
                counters) -> dict:
    """Phase 23 (its checks in the docstring's step 23): the W = 2048
    builds on the mapping batch (the plain versions on its first 4
    reads, the walks on all 512), the engine at W = 2048, the W = 1536
    and 2048 builds at the live widths 1100, 1536, 1800 and 2048 on
    phase 13's reads, the engine, ``realign`` and EM at 1800 card against
    CPU, and the refusals of :func:`refusal_check`.  Returns the
    kernels' ``*_w2048`` (the mapping batch) and live widths'
    (``*_w1100``, ``*_live1536``, ...) numbers and each run's
    launches."""
    import dataclasses

    import torch

    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    t_phase = time.perf_counter()
    res, runs = {}, {}
    top = W2048[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    mapping_batch_checks(pairs, engine.params, dev, res, top,
                         W2048_PLAIN_READS, "phase 23", pack_plain_all=False)
    print("phase 23: peak device memory of this process on the mapping "
          "batch %.3f GB" % (torch.cuda.max_memory_allocated(dev) / 1e9))
    wdir = os.path.join(os.path.dirname(fq), "w2048")
    os.makedirs(wdir, exist_ok=True)
    ref = read_fasta_dict(fa)
    cfg = dataclasses.replace(engine.config, band_width=top, decode="mea")
    runs["w2048_map"] = warm_engine_run(
        ref, cfg, engine, fq, os.path.join(wdir, "map_w%d.sam" % top), dev,
        counters, "phase 23", MEA_KERNELS)
    torch.cuda.empty_cache()

    # ---- live widths of 1100, 1536, 1800 and 2048 on phase 13's reads ----
    for w in W2048_LIVE:
        width_kernel_checks(wl["pairs"], w, dev, res, "phase 23",
                            viterbi=False)

    # ---- the engine, realign and EM at 1800, card against CPU ----
    live = dataclasses.replace(cfg, band_width=W2048_CPU)
    runs["w2048_engine"] = engine_card_vs_cpu(
        ref, live, engine, fq, wdir, dev, counters, "phase 23", MEA_KERNELS)
    runs["w2048_realign"] = realign_cli_check(wl, W2048_CPU, counters,
                                              "phase 23")
    runs["w2048_em"] = em_width_check(wl, W2048_CPU, dev, counters,
                                      "phase 23")
    refusal_check(ref, cfg, engine, pairs, dev, "phase 23")
    print("phase 23 wall: %.1f s" % (time.perf_counter() - t_phase))
    return {"res": res, "runs": runs}


def full_plane_alone() -> int:
    """Run as ``chip_smoke.py --full-plane``: the kernels' build, then
    phase 14 alone on the mapping workload."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.kernels import build
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print("build: %.1f s" % build.build())
    dev = torch.device("cuda", 0)
    workdir = os.path.join(build.BUILD_DIR, "smoke", "full_plane_alone")
    fa, fq = write_workload(workdir, REF_LEN)
    engine = MappingEngine(read_fasta_dict(fa),
                           MAPPER_REGISTRY["LastParams"].config, device=dev)
    pairs = main_path_batch(engine, fq, preferred_realign_batch_size(None, dev))
    res = {}
    run = full_plane_phase(engine, pairs, fa, fq, dev, launch_counters(), res)
    print(card)
    print(json.dumps({"res": res, "run": run}))
    return 0


def widths_alone() -> int:
    """Run as ``chip_smoke.py --widths``: the kernels' build, then phase
    13 alone (what a change to the live width's handling needs)."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print("build: %.1f s" % build.build())
    dev = torch.device("cuda", 0)
    cpu = start_cpu_halves([(13,)], dev)
    wl = width_workload(os.path.join(build.BUILD_DIR, "smoke"), dev)
    out = widths_phase(wl, dev, launch_counters())
    finish_cpu_halves(cpu)
    print(card)
    print(json.dumps(out))
    return 0


# ---- the wide phases alone ---- #

def phase_alone(phase: int, run_phase, paths, widths) -> int:
    """Run as ``chip_smoke.py <flag>`` (:data:`PHASE_ALONE`): the kernels'
    build and the attributes of ``paths``' builds at ``widths``
    (:func:`widths_attributes`), then ``run_phase`` (phase ``phase``)
    alone on its own copies of the mapping workload and of phase 13's
    reads (:func:`wider_workloads`, under ``smoke/<name>_alone``), its CPU
    halves in their own process."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print("build: %.1f s" % build.build())
    attrs = widths_attributes(widths, paths)
    dev = torch.device("cuda", 0)
    cpu = start_cpu_halves([(phase,)], dev)
    workdir = os.path.join(build.BUILD_DIR, "smoke", run_phase.__name__
                           .replace("_phase", "_alone"))
    engine, pairs, fa, fq, wl = wider_workloads(workdir, dev)
    out = run_phase(engine, pairs, fa, fq, wl, dev, launch_counters())
    finish_cpu_halves(cpu)
    for name, a in attrs.items():
        out["res"].setdefault(name, {}).update(a)
    print(card)
    print(json.dumps(out))
    return 0


# the phases that run alone through :func:`phase_alone`: flag -> (phase,
# its function, the paths and widths of the builds it holds)
PHASE_ALONE = {
    "--wider": (16, wider_phase, (mea_path_attributes,), (WIDER_W,)),
    "--viterbi-wider": (17, viterbi_wider_phase, (viterbi_path_attributes,),
                        (WIDER_W,)),
    "--widest": (18, widest_phase, (mea_path_attributes,), WIDEST_W),
    "--viterbi-widest": (19, viterbi_widest_phase,
                         (viterbi_path_attributes,), WIDEST_W),
    "--widest-1024": (21, w1024_phase, (mea_path_attributes,), W1024),
    "--viterbi-w1024": (22, viterbi_w1024_phase, (viterbi_path_attributes,),
                        W1024),
    "--mea-w2048": (23, w2048_phase, (mea_path_attributes,), W2048),
}


# ---- the CPU halves of the card-against-CPU checks (their own process) ---- #

# per phase, the CPU halves of its card-against-CPU checks, in the order
# the card phases reach them: ("engine", w, decode) for engine_run,
# ("realign", w) for the realign subcommand, ("em", w) for em_width_run
CPU_HALVES = {
    13: (("realign", LIVE_WIDTHS[0]), ("em", LIVE_WIDTHS[1])),
    15: (("engine", WIDE_W, "mea"), ("realign", WIDE_LIVE), ("em", WIDE_LIVE),
         ("engine", WIDE_LIVE, "viterbi")),
    16: (("engine", WIDER_LIVE, "mea"), ("realign", WIDER_LIVE),
         ("em", WIDER_LIVE)),
    17: (("engine", WIDER_LIVE, "viterbi"),),
    18: (("engine", WIDEST_CPU, "mea"), ("realign", WIDEST_CPU),
         ("em", WIDEST_CPU)),
    19: (("engine", WIDEST_CPU, "viterbi"),),
    21: (("engine", W1024_CPU, "mea"), ("realign", W1024_CPU),
         ("em", W1024_CPU)),
    22: (("engine", W1024_CPU, "viterbi"),),
    23: (("engine", W2048_CPU, "mea"), ("realign", W2048_CPU),
         ("em", W2048_CPU)),
}
# the CPU halves' processes of a whole run: phases 21's and 22's at
# W = 1024 (~300 s on one thread, then the Viterbi engine's) in a second
# process, beside the first's ~600 s, and phase 23's at W = 2048 in a
# third
CPU_HALF_GROUPS = ((13, 15, 16, 17, 18, 19), (21, 22), (23,))
CPU_HALF_WAIT = 900  # seconds a card phase waits for a CPU half
# torch threads of the CPU halves: their plain versions are bound by
# the cost of each small op, so more threads only take cores from the
# card phases' host work
CPU_HALF_THREADS = 1


def cpu_dir() -> str:
    """The CPU halves' process's directory: its inputs and outputs."""
    return os.path.join(ROOT, "nanopore_tpu_torch", "_build", "smoke",
                        "cpu_halves")


def half_key(kind: str, w: int, decode: str = "") -> str:
    return "%s_%sw%d" % (kind, decode + "_" if decode else "", w)


def group_name(phases) -> str:
    """A CPU halves' process's name: ``cpu-halves-13-15-...``."""
    return "cpu-halves-" + "-".join(str(p) for p in phases)


def start_cpu_halves(groups, dev) -> list:
    """Clear :func:`cpu_dir`, map phase 13's reads there on the card (the
    CPU halves' processes map nothing) and start, for each group of
    phases, ``chip_smoke.py --cpu-halves <phases>`` with no card visible,
    its log in ``<dir>/<group_name>_child.log``; each is killed at exit
    if still running."""
    import shutil

    shutil.rmtree(cpu_dir(), ignore_errors=True)
    width_workload(cpu_dir(), dev)
    return [(phases, start_child(
        cpu_dir(), "--cpu-halves", [",".join(str(p) for p in phases)],
        dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        log=group_name(phases))) for phases in groups]


def cpu_halves_child(phases) -> int:
    """Run as ``chip_smoke.py --cpu-halves 13,15,...`` with no card
    visible, beside the card phases: the CPU halves of those phases'
    card-against-CPU checks (``CPU_HALVES``), in order, on their own
    copy of the seeded mapping workload and on the mapping of phase
    13's reads that :func:`start_cpu_halves` wrote.  Each writes its
    output under its own directory there, then ``<key>.json`` (the
    output's path and wall seconds) into :func:`cpu_dir`, where
    :func:`cpu_half` waits for it; a failure
    writes ``FAILED`` (the traceback) there and exits non-zero.  It runs
    at a lower priority (nice 10) on CPU_HALF_THREADS torch threads: the
    card phases' host work, which sets their times, shares the cores."""
    import traceback

    import torch

    os.nice(10)
    torch.set_num_threads(CPU_HALF_THREADS)
    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY

    d = cpu_dir()
    own = os.path.join(d, group_name(phases))
    try:
        fa, fq = write_workload(os.path.join(own, "mapping"), REF_LEN)
        ref = read_fasta_dict(fa)
        cfg = MAPPER_REGISTRY["LastParams"].config
        wl = width_workload(d)
        for phase in phases:
            for spec in CPU_HALVES[phase]:
                t0 = time.perf_counter()
                kind, w = spec[:2]
                key = half_key(*spec)
                if kind == "engine":
                    import dataclasses

                    path = engine_run(ref, dataclasses.replace(
                        cfg, band_width=w, decode=spec[2]), fq, own, "cpu")
                elif kind == "realign":
                    from nanopore_tpu_torch import cli

                    path = os.path.join(own, key + ".sam")
                    cli.main(["realign", *realign_subset(wl)[0], path,
                              "--band-width", str(w), "--device", "cpu"])
                else:
                    host = em_width_run(wl, w, "cpu")
                    path = os.path.join(own, key + ".npz")
                    with open(path, "wb") as fh:
                        np.savez(fh, transitions=host.model.transitions,
                                 emissions=host.model.emissions,
                                 running=np.asarray(
                                     host.running_likelihoods[0]))
                rec = {"phase": phase, "path": path,
                       "wall": time.perf_counter() - t0}
                with open(os.path.join(d, key + ".tmp"), "w") as fh:
                    json.dump(rec, fh)
                os.replace(os.path.join(d, key + ".tmp"),
                           os.path.join(d, key + ".json"))
                print("phase %d's CPU half %s: %.1f s" % (phase, key,
                                                          rec["wall"]),
                      flush=True)
    except BaseException:
        with open(os.path.join(d, "FAILED"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    return 0


def cpu_half(key: str) -> dict:
    """Wait for the CPU halves' process to write ``key``'s record (its
    output's ``path``, its ``wall`` seconds); its failure, or a wait of
    CPU_HALF_WAIT seconds, fails the script."""
    done = os.path.join(cpu_dir(), key + ".json")
    failed = os.path.join(cpu_dir(), "FAILED")
    t0 = time.perf_counter()
    while not os.path.exists(done):
        if os.path.exists(failed):
            with open(failed) as fh:
                fail("the CPU halves' process failed:\n" + fh.read()[-3000:])
        if time.perf_counter() - t0 > CPU_HALF_WAIT:
            fail("no CPU half %s after %d s" % (key, CPU_HALF_WAIT))
        time.sleep(0.5)
    with open(done) as fh:
        rec = json.load(fh)
    print("  the CPU half %s (%.1f s in the CPU process): waited %.1f s"
          % (key, rec["wall"], time.perf_counter() - t0))
    return rec


def finish_cpu_halves(procs) -> None:
    """Wait for the CPU halves' processes; a failure fails the script."""
    for phases, proc in procs:
        t0 = time.perf_counter()
        rc = proc.wait(timeout=CPU_HALF_WAIT)
        with open(os.path.join(cpu_dir(),
                               group_name(phases) + "_child.log")) as fh:
            lines = fh.read().splitlines()
        print("the CPU halves' process of phases %s (beside the card "
              "phases): waited %.1f s after the last card phase; its lines:"
              % (", ".join(map(str, phases)), time.perf_counter() - t0))
        for line in lines:
            if " INFO " not in line:
                print("  " + line)
        if rc != 0:
            fail("the CPU halves' process of phases %s exited with %d"
                 % (", ".join(map(str, phases)), rc))


def launch_counters() -> tuple:
    from nanopore_tpu_torch.ops import forward, pack, realign, traceback, viterbi

    return (pack.LAUNCHES, realign.LAUNCHES, realign.EM_LAUNCHES,
            realign.GAMMA_LAUNCHES, realign.DECODE_GAMMA_LAUNCHES,
            realign.EXP_LAUNCHES, traceback.LAUNCHES, viterbi.LAUNCHES,
            traceback.VIT_LAUNCHES, viterbi.FULL_LAUNCHES,
            traceback.VIT_FULL_LAUNCHES, forward.LAUNCHES)


def pipeline_child() -> int:
    """Run as ``chip_smoke.py --pipeline`` in a child process, beside the
    parent's phases 2-9 (the pipeline's host work and the parent's plain
    versions each hold a core; the card is idle most of either): phases
    10, 11, 12, 16, 18 and 19, their launch counts written to
    ``<workdir>/pipeline/launches.json`` and phases 16's, 18's and 19's
    kernel rows to ``<workdir>/wider/result.json`` for the kernels
    line."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.kernels import build

    workdir = os.path.join(build.BUILD_DIR, "smoke")
    dev = torch.device("cuda", 0)
    counters = launch_counters()
    runs = {"pipeline": pipeline_phase(workdir, dev, counters)}
    runs["rescue_2d"] = rescue_phase(workdir, dev, counters)
    runs["distributed"] = distributed_phase(workdir)
    # phases 16, 18 and 19 last: the card's memory is shared by three
    # processes, so this one's cached blocks go back before the W = 256,
    # 384 and 512 workspaces; phases 18 and 19 take phase 16's workloads
    torch.cuda.empty_cache()
    loads = wider_workloads(os.path.join(workdir, "wider"), dev)
    wider = wider_phase(*loads, dev, counters)
    torch.cuda.empty_cache()
    widest = widest_phase(*loads, dev, counters)
    torch.cuda.empty_cache()
    viterbi_widest = viterbi_widest_phase(*loads, dev, counters)
    for out in (wider, widest, viterbi_widest):
        runs.update(out["runs"])
    for out in (widest, viterbi_widest):
        for name, rows in out["res"].items():
            wider["res"].setdefault(name, {}).update(rows)
    with open(os.path.join(workdir, "wider", "result.json"), "w") as fh:
        json.dump({"res": wider["res"]}, fh)
    with open(os.path.join(workdir, "pipeline", "launches.json"), "w") as fh:
        json.dump(runs, fh)
    return 0


def viterbi_child() -> int:
    """Run as ``chip_smoke.py --viterbi`` in a second child process,
    beside the parent's phases 5-7: phase 8 on its own copy of the
    mapping workload (the same seed, so the same batch), then phases 13,
    14, 15, 17, 22 and 23 (this process's cached card memory released
    before each of the last three); their
    kernel rows, the forward entry's and phases 13's, 14's, 15's, 17's,
    22's and 23's launch counts written to
    ``<workdir>/viterbi/result.json`` for the kernels line."""
    import torch

    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.kernels import build
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size

    workdir = os.path.join(build.BUILD_DIR, "smoke", "viterbi")
    dev = torch.device("cuda", 0)
    fa, fq = write_workload(workdir, REF_LEN)
    engine = MappingEngine(read_fasta_dict(fa),
                           MAPPER_REGISTRY["LastParams"].config, device=dev)
    pairs = main_path_batch(engine, fq, preferred_realign_batch_size(None, dev))
    res = {}
    entry = viterbi_kernel_phase(engine, pairs, dev, launch_counters(), res)
    wl = width_workload(os.path.dirname(workdir), dev)
    widths = widths_phase(wl, dev, launch_counters())
    full = full_plane_phase(engine, pairs, fa, fq, dev, launch_counters(),
                            res)
    wide = wide_phase(engine, pairs, fa, fq, wl, dev, launch_counters())
    torch.cuda.empty_cache()  # the card's memory is shared by three processes
    viterbi_wider = viterbi_wider_phase(engine, pairs, fa, fq, wl, dev,
                                        launch_counters())
    torch.cuda.empty_cache()  # before the W = 1024 planes
    viterbi_w1024 = viterbi_w1024_phase(engine, pairs, fa, fq, wl, dev,
                                        launch_counters())
    torch.cuda.empty_cache()  # before the W = 2048 batches
    w2048 = w2048_phase(engine, pairs, fa, fq, wl, dev, launch_counters())
    with open(os.path.join(workdir, "result.json"), "w") as fh:
        json.dump({"res": res, "forward_entry": entry, "widths": widths,
                   "full_plane": full, "wide": wide,
                   "viterbi_wider": viterbi_wider,
                   "viterbi_w1024": viterbi_w1024, "w2048": w2048}, fh)
    return 0


def start_child(workdir: str, flag: str, args=(), env=None, log=None):
    """Start ``chip_smoke.py <flag> <args>`` (``--pipeline``: phases
    10-12, 16, 18 and 19; ``--viterbi``: phases 8, 13, 14, 15, 17, 22 and
    23;
    ``--cpu-halves``: CPU halves), its output in ``<workdir>/<log, by
    default the flag without dashes>_child.log``, under ``env``
    (default: this process's); it is killed at exit if still running."""
    import atexit

    os.makedirs(workdir, exist_ok=True)
    log = open(os.path.join(workdir, (log or flag.lstrip("-"))
                            + "_child.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, *args],
        stdout=log, stderr=subprocess.STDOUT, text=True, env=env)
    log.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def script_time(path: str, t_start: float) -> float:
    """Seconds from the script's start (``t_start``, on
    ``time.perf_counter``) to ``path``'s last write."""
    return os.path.getmtime(path) - time.time() + (time.perf_counter()
                                                   - t_start)


def finish_child(proc, workdir: str, flag: str, what: str, t_start: float,
                 result: str) -> dict:
    """Wait for the child started with ``flag``, print its lines (not its
    log records) and return what it wrote to ``<workdir>/<result>``; its
    failure fails the script."""
    t0 = time.perf_counter()
    rc = proc.wait(timeout=1200)
    log = os.path.join(workdir, flag.lstrip("-") + "_child.log")
    print("%s (a child process beside the parent's phases): waited %.1f s "
          "after the parent's last phase; its last line at %.1f s of the "
          "script" % (what, time.perf_counter() - t0,
                      script_time(log, t_start)))
    with open(log) as fh:
        lines = fh.read().splitlines()
    for line in lines:
        if " INFO " not in line:
            print(line)
    if rc != 0:
        print("\n".join(lines[-40:]))
        fail("%s exited with %d" % (what, rc))
    with open(os.path.join(workdir, result)) as fh:
        return json.load(fh)


def glue_err(out: list, want: dict) -> tuple:
    """(largest difference, within the CPU tests' rtol 1e-3 and atol
    2e-3) of the SNP caller's (n_ref, 4) matrices from ``want``
    ({record: (window start, window matrix)}, zero outside the window);
    the two must agree on which entries are finite."""
    err, ok = 0.0, True
    for idx, (j0, e) in want.items():
        w = np.zeros_like(out[idx])
        w[j0:j0 + len(e)] = e
        fin = np.isfinite(w)
        if not np.array_equal(fin, np.isfinite(out[idx])):
            return float("inf"), False
        if fin.any():
            err = max(err, float(np.abs(out[idx] - w)[fin].max()))
        ok = ok and np.allclose(out[idx][fin], w[fin], rtol=1e-3, atol=2e-3)
    return err, ok


def origin_share(sam_path: str) -> float:
    """Share of reads whose primary record is on their strand within
    100 bp of their origin."""
    from nanopore_tpu_torch.io.sam import SamReader

    hits = 0
    for rec in SamReader(sam_path):
        if rec.flag & 0x904:
            continue
        _, start, strand = rec.qname[1:].split("_")
        if bool(rec.flag & 0x10) == bool(int(strand)) and abs(
            rec.pos - int(start)
        ) <= 100:
            hits += 1
    return hits / N_READS


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--cpu-halves"] and len(sys.argv) == 3:
        return cpu_halves_child([int(p) for p in sys.argv[2].split(",")])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "nanopore_tpu_torch", "csrc")):
        print("chip_smoke: nanopore_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--kend-guard"]:
        return kend_guard_child()
    if sys.argv[1:] == ["--pipeline"]:
        return pipeline_child()
    if sys.argv[1:] == ["--viterbi"]:
        return viterbi_child()
    if sys.argv[1:] == ["--widths"]:
        return widths_alone()
    if sys.argv[1:] == ["--full-plane"]:
        return full_plane_alone()
    if sys.argv[1:] == ["--wide"]:
        return wide_alone()
    if len(sys.argv) == 2 and sys.argv[1] in PHASE_ALONE:
        return phase_alone(*PHASE_ALONE[sys.argv[1]])
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 6:
        return distributed_rank(int(sys.argv[2]), *sys.argv[3:])
    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.kernels import build
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.mapping.runner import run_mapper
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.ops import pack, realign, traceback
    from nanopore_tpu_torch.runtime import native_index

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    print("build: %.1f s" % build.build())
    attrs = {}  # kernel name -> shape of its blocks, for the kernels line
    for width in (W, W_REALIGN):
        tag = "" if width == W else "_w32"
        for mode, a in realign.kernel_attributes(width).items():
            print("realign %s W=%d: %d registers, %d bytes of local memory "
                  "(spills) a thread, %d + %d bytes of static + dynamic "
                  "shared memory a block of %d threads and %d read(s)"
                  % (mode, width, a["registers"], a["local_bytes"],
                     a["static_smem"], a["dynamic_smem"], a["threads"],
                     a["reads"]))
            name = "realign" if mode == "decode" else "realign_" + mode
            attrs.setdefault(name, {}).update({
                "registers" + tag: a["registers"],
                "local_bytes" + tag: a["local_bytes"],
                "smem_block" + tag: a["static_smem"] + a["dynamic_smem"],
                "warps_per_read" + tag: a["threads"] // 32 // a["reads"],
            })
        a = pack.kernel_attributes(width)
        print("pack W=%d: %d registers, %d bytes of local memory a thread, "
              "%d bytes of static shared memory a block of %d threads (one "
              "read)" % (width, a["registers"], a["local_bytes"],
                         a["static_smem"], a["threads"]))
        attrs.setdefault("pack", {}).update({
            "registers" + tag: a["registers"],
            "smem_block" + tag: a["static_smem"],
            "warps_per_read" + tag: a["threads"] // 32,
        })
        for name, a in viterbi_path_attributes(width, tag).items():
            attrs.setdefault(name, {}).update(a)
    for width in (W, W_REALIGN):
        smem = traceback.walker_shared_memory(width)
        print("walkers W=%d: dynamic shared memory a block of 4 reads %s"
              % (width, smem))
        tag = "" if width == W else "_w32"
        for name, b in smem.items():
            attrs.setdefault(name, {})["smem_block" + tag] = b
    for name, a in widths_attributes(
            (WIDE_W, WIDER_W) + WIDEST_W + W1024,
            (mea_path_attributes, viterbi_path_attributes)).items():
        attrs.setdefault(name, {}).update(a)
    for name, a in widths_attributes(W2048, (mea_path_attributes,)).items():
        attrs.setdefault(name, {}).update(a)
    # seeding and chaining run only in the native library: build it here
    # so a failure stops the run before any timing
    print("native seedchain: %s" % native_index.get_lib()._name)
    dev = torch.device("cuda", 0)
    workdir = os.path.join(build.BUILD_DIR, "smoke")
    counters = launch_counters()
    # the CPU halves of phases 13, 15-19 and 21-23 beside every card phase
    cpu = start_cpu_halves(CPU_HALF_GROUPS, dev)
    kend_guard_check()
    pipeline = start_child(workdir, "--pipeline")
    t_mark = [t_start]

    def mark(what):
        now = time.perf_counter()
        print("%s wall: %.1f s" % (what, now - t_mark[0]))
        t_mark[0] = now

    mark("phases 1 (build and guard)")
    fa, fq = write_workload(workdir, REF_LEN)

    spec = MAPPER_REGISTRY["LastParams"]
    engine = MappingEngine(read_fasta_dict(fa), spec.config, device=dev)
    res = kernel_phase(engine, fq, dev)
    mark("phases 2-3 (workload, kernel rows)")

    # ---- end to end: cold run, then the warm run that counts ----
    sam = os.path.join(workdir, "out.sam")
    run_mapper(spec, fq, "reads", fa, sam, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    warm = run_mapper(spec, fq, "reads", fa, sam, device=dev)
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    share = origin_share(sam)
    print("end to end: %d reads in %.3f s warm = %.1f reads/s; peak device "
          "memory %.3f GB; primaries at origin %.4f; launches %s"
          % (N_READS, wall, N_READS / wall, peak / 1e9, share, launches))
    print("stage_stats " + json.dumps(warm.stage_stats.snapshot()))
    # the mapping path runs pack, the decode mode and the walker
    if min(launches[k] for k in ("pack", "realign", "traceback")) <= 0:
        fail("a kernel of the main path was not launched: %s" % launches)
    if share < 0.99:
        fail("only %.4f of primaries at their origin" % share)

    mark("phase 4")
    # phase 8 beside phases 5-7: after the main path's kernel rows and
    # its end-to-end run, which are timed with no other process's
    # kernels and plain versions on the card but the pipeline's
    vit_child = start_child(workdir, "--viterbi")
    em_launches = em_path_phase(workdir, dev, counters, res)
    mark("phases 5-6")
    post_launches = posterior_path_phase(workdir, dev, counters, res)
    mark("phase 7")
    vit_launches = viterbi_path_phase(workdir, fa, fq, dev, counters)
    mark("phase 9")
    # phase 21 last in this process, which ends first without it; its
    # cached card memory released first (three processes share the card)
    from nanopore_tpu_torch.ops.dispatch import preferred_realign_batch_size

    torch.cuda.empty_cache()
    w1024 = w1024_phase(
        engine, main_path_batch(engine, fq,
                                preferred_realign_batch_size(None, dev)),
        fa, fq, width_workload(os.path.join(workdir, "w1024"), dev), dev,
        counters)
    mark("phase 21")
    phase8 = finish_child(vit_child, workdir, "--viterbi",
                          "phases 8, 13, 14, 15, 17, 22 and 23", t_start,
                          os.path.join("viterbi", "result.json"))
    res.update(phase8["res"])
    other_runs = dict(post_launches, **vit_launches)
    for out in (phase8["widths"], phase8["wide"], phase8["viterbi_wider"],
                w1024, phase8["viterbi_w1024"], phase8["w2048"]):
        for name, rows in out["res"].items():
            res[name].update(rows)
        other_runs.update(out["runs"])
    other_runs.update(finish_child(pipeline, workdir, "--pipeline",
                                   "phases 10-12, 16, 18 and 19", t_start,
                                   os.path.join("pipeline", "launches.json")))
    finish_cpu_halves(cpu)
    with open(os.path.join(workdir, "wider", "result.json")) as fh:
        for name, rows in json.load(fh)["res"].items():
            res[name].update(rows)
    other_runs["forward_entry"] = phase8["forward_entry"]
    # no canonical model may take the full plane: its counters are 0 in
    # every driven run but phase 14's
    earlier = dict(other_runs, map=launches, em=em_launches)
    took = {what: (run["viterbi_full"], run["viterbi_traceback_full"])
            for what, run in earlier.items()
            if run["viterbi_full"] or run["viterbi_traceback_full"]}
    if took:
        fail("runs other than phase 14's launched the full plane: %s" % took)
    other_runs["full_plane"] = phase8["full_plane"]

    meta = {
        "pack": ("csrc/pack.cu", "nanopore_tpu/ops/pack_pallas.py:61"),
        "realign": ("csrc/realign.cu",
                    "nanopore_tpu/ops/pairhmm_pallas_realign.py:69"),
        "traceback": ("csrc/traceback.cu",
                      "nanopore_tpu/ops/traceback_pallas.py:44"),
        "realign_em": ("csrc/realign.cu",
                       "nanopore_tpu/ops/pairhmm_pallas_realign.py:69"),
        "realign_gamma": ("csrc/realign.cu",
                          "nanopore_tpu/ops/pairhmm_pallas_realign.py:69"),
        "realign_decode_gamma": (
            "csrc/realign.cu",
            "nanopore_tpu/ops/pairhmm_pallas_realign.py:69"),
        "realign_exp": ("csrc/realign.cu",
                        "nanopore_tpu/ops/pairhmm_pallas_realign.py:69"),
        "viterbi": ("csrc/viterbi.cu",
                    "nanopore_tpu/ops/pairhmm_pallas_viterbi.py:72"),
        "viterbi_traceback": ("csrc/viterbi_traceback.cu",
                              "nanopore_tpu/ops/traceback_pallas.py:239"),
        "viterbi_full": ("csrc/viterbi.cu", "nanopore_tpu/ops/viterbi.py:51"),
        "viterbi_traceback_full": ("csrc/viterbi_traceback.cu",
                                   "nanopore_tpu/ops/viterbi.py:135"),
        "forward": ("csrc/forward.cu", "nanopore_tpu/ops/pairhmm_pallas.py:92"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = res[name]
        row = {
            "name": name, "route": "cuda",
            "source": "nanopore_tpu_torch/" + src, "replaces": replaces,
            # launches in the driven runs together; each run's count,
            # read from counters set to 0 just before it, follows
            "launches": launches[name] + em_launches[name] + sum(
                run[name] for run in other_runs.values()),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "launches_map_path": launches[name],
            "launches_em_path": em_launches[name],
        }
        for what, run in other_runs.items():
            row["launches_%s%s" % (what, "" if what == "forward_entry"
                                   else "_path")] = run[name]
        row.update({k: v for k, v in r.items() if k not in row
                    and k != "per_batch"})
        row.update(attrs.get(name, {}))
        kernels.append(row)
    print("chip_smoke wall: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
