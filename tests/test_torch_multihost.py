"""The port's parallel layer across real processes: two gloo ranks on
localhost, each on the CPU (``device="cpu"``).

* Sharded EM (``EmOptions(use_mesh=True)``) on two ranks, on both
  meshes: 1 trial gives dp 2 x trial 1 (the E-step's float64 sums
  all-reduce across the processes), 2 trials give dp 1 x trial 2 (each
  rank trains one trial and the trials are gathered).  Both ranks return
  the same models, equal to the one-rank run within 1e-9 relative and to
  the JAX package's ``_em_train_sharded`` at the single-device EM bar of
  tests/test_torch_em.py (atol 1e-4 on table entries, rtol 1e-5 on the
  likelihoods and traces).  The pairs and options are
  tests/test_torch_parallel.py's.
* The two-rank pipeline, tests/test_multihost.py's
  ``test_two_process_pipeline_e2e`` for the port: its three reads and its
  configuration, each rank the real entry point ``python -m
  nanopore_tpu_torch run <wd> --device cpu`` under the three environment
  variables.  Its EM runs at the ``run`` subcommand's band width (the
  ``EmOptions`` default, 64) with 1 trial x 3 iterations, so the
  E-step's sums cross the process boundary (the trial split is the EM
  test's).  No shard litter; the DONE markers, the model files and the
  meta directory; the chain experiment's ``mapping.sam`` byte-identical
  to the port's single-process pipeline and to the JAX package's (which
  runs that experiment alone); the EM experiment's records equal to the
  single-process run's in their first four fields, as the JAX test
  requires, and its trained model within 1e-9 relative.
* ``run_mapper("LastParamsRealignEm", ..., em_options=None,
  distributed=True)`` on two ranks trains at the preset's band width,
  32, as the JAX package's multi-host runner does (ROADMAP C12): its
  model within 1e-9 relative of one process's run with
  ``EmOptions(band_width=32)``, and apart from the one at 64 (the
  ``EmOptions`` default).  The runner's own ``EmOptions`` is cut to 1
  trial x 2 iterations in the ranks; its band width stays the runner's.

The workers are this file (``python tests/test_torch_multihost.py em
<rank> <world> <port> <out>``, and ``c12 <rank> <world> <port> <wd>``).  Every wait for the ranks has a time
limit that kills them all, so a hung rank fails its test.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EM_OPTS = dict(iterations=3, band_width=64, seed=3, window_pad=16,
               batch_size=8, convergence_tol=0.22)
PIPELINE_MAPPERS = ["LastParamsChain", "LastParamsRealignEm"]
PIPELINE_ARGS = ["--mappers", ",".join(PIPELINE_MAPPERS),
                 "--analyses", "GlobalCoverage,Substitutions",
                 "--meta-analyses", "CoverageSummary", "--max-threads", "2",
                 "--em-trials", "1", "--em-iterations", "3"]
RANK_TIMEOUT = 240  # seconds a group of ranks may take
# what a rank prints when a process group is left to the interpreter's
# exit and one of its threads is still joinable (ROADMAP C13)
ABORT = "terminate called without an active exception"


def em_pairs(seed=5, count=4, n_ref=400):
    """Chained-style global pairs on one reference: lead and tail
    deletions longer than the window pad (so each has a flank
    correction) around a noisy 60-100 base read; no window reaches the
    reference's end (ROADMAP C6)."""
    from nanopore_tpu_torch.io.sam import CIG

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, n_ref).astype(np.int8)
    pairs = []
    for _ in range(count):
        mlen = int(rng.integers(60, 100))
        lead = int(rng.integers(40, n_ref - mlen - 40))
        y = x[lead:lead + mlen].copy()
        idx = rng.integers(0, mlen, mlen // 10)
        y[idx] = (y[idx] + 1) % 4
        y = np.concatenate([y[:30], y[33:]])  # a 3-base deletion
        guide = [(CIG.D, lead), (CIG.M, 30), (CIG.D, 3),
                 (CIG.M, mlen - 33), (CIG.D, n_ref - lead - mlen)]
        pairs.append((x, y, guide))
    return pairs


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_all(procs, timeout=RANK_TIMEOUT) -> list:
    """Each rank's output; a rank past the time limit kills every rank
    and fails the test."""
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("a rank did not finish within %d s" % timeout)
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, "rank failed:\n" + log[-4000:]
        assert ABORT not in log, "a rank aborted at exit:\n" + log[-4000:]
    return logs


def rank_env(**extra) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for key in ("NANOPORE_TPU_COORDINATOR", "NANOPORE_TPU_NUM_PROCESSES",
                "NANOPORE_TPU_PROCESS_ID"):
        env.pop(key, None)
    env.update(extra)
    return env


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def result_arrays(res) -> dict:
    return {
        "t": np.stack([m.transitions for m in res.trial_models]),
        "e": np.stack([m.emissions for m in res.trial_models]),
        "traces": [list(tr) for tr in res.running_likelihoods],
        "best": float(res.model.likelihood),
    }


def assert_close_at(got: dict, want: dict, rtol: float) -> None:
    assert [len(t) for t in got["traces"]] == \
        [len(t) for t in want["traces"]]
    for g, w in zip(got["traces"], want["traces"]):
        assert rel(g, w) <= rtol
    assert rel(got["best"], want["best"]) <= rtol
    for key in ("t", "e"):
        nz = want[key] != 0
        assert np.array_equal(got[key] != 0, nz)
        assert rel(got[key][nz], want[key][nz]) <= rtol


def assert_em_bar(got: dict, jax_res) -> None:
    """tests/test_torch_em.py's bar against a JAX EmResult."""
    want = result_arrays(jax_res)
    assert [len(t) for t in got["traces"]] == \
        [len(t) for t in want["traces"]]
    for g, w in zip(got["traces"], want["traces"]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    np.testing.assert_allclose(got["best"], want["best"], rtol=1e-5)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-4)
    np.testing.assert_allclose(got["e"], want["e"], atol=1e-4)


# ---- sharded EM on two ranks ------------------------------------------ #

def em_worker(rank: int, world: int, port: int, out: str) -> int:
    from nanopore_tpu_torch.align import em
    from nanopore_tpu_torch.parallel import distributed as dist
    from nanopore_tpu_torch.parallel.mesh import make_mesh

    dist.initialize_distributed("localhost:%d" % port, world, rank)
    result = {"rank": dist.process_info()}
    for trials in (1, 2):
        res = em.em_train(em_pairs(), em.EmOptions(
            use_mesh=True, trials=trials, **EM_OPTS), device="cpu")
        arrays = result_arrays(res)
        result[str(trials)] = {
            "mesh": make_mesh(n_trials=trials).shape,
            "t": arrays["t"].tolist(), "e": arrays["e"].tolist(),
            "traces": arrays["traces"], "best": arrays["best"],
        }
    dist.barrier("done")
    dist.shutdown_distributed()
    with open(out, "w") as fh:
        json.dump(result, fh)
    return 0


@pytest.fixture(scope="module")
def two_rank_em(tmp_path_factory):
    """Both ranks' results; the one-rank and JAX references are computed
    while the ranks run."""
    from nanopore_tpu.align import em as jax_em
    from nanopore_tpu_torch.align import em

    d = tmp_path_factory.mktemp("two_rank_em")
    port = free_port()
    outs = [str(d / ("rank%d.json" % r)) for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "em", str(r), "2",
         str(port), outs[r]],
        env=rank_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        one_rank, jax_runs = {}, {}
        for trials in (1, 2):
            one_rank[trials] = result_arrays(em.em_train(
                em_pairs(), em.EmOptions(use_mesh=True, trials=trials,
                                         **EM_OPTS), device="cpu"))
            # the JAX em_train windows the pairs and hands them to its
            # _em_train_sharded (on the 8-device CPU mesh of conftest.py)
            jax_runs[trials] = jax_em.em_train(em_pairs(), jax_em.EmOptions(
                use_mesh=True, trials=trials, **EM_OPTS))
    finally:
        wait_all(procs)
    ranks = []
    for path in outs:
        with open(path) as fh:
            got = json.load(fh)
        ranks.append({int(k): {**v, "t": np.asarray(v["t"]),
                               "e": np.asarray(v["e"])}
                      for k, v in got.items() if k != "rank"})
        assert got["rank"] == [len(ranks) - 1, 2]
    return ranks, one_rank, jax_runs


@pytest.mark.parametrize("trials,mesh", [(1, {"dp": 2, "trial": 1}),
                                         (2, {"dp": 1, "trial": 2})])
def test_two_rank_sharded_em(two_rank_em, trials, mesh):
    ranks, one_rank, jax_runs = two_rank_em
    r0, r1 = ranks[0][trials], ranks[1][trials]
    assert r0["mesh"] == r1["mesh"] == mesh
    # every rank holds the same models
    for key in ("t", "e"):
        assert np.array_equal(r0[key], r1[key])
    assert r0["traces"] == r1["traces"] and r0["best"] == r1["best"]
    assert_close_at(r0, one_rank[trials], 1e-9)
    assert_em_bar(r0, jax_runs[trials])


# ---- the two-rank pipeline -------------------------------------------- #

def _copy_inputs(src, dst):
    for sub in ("readFastqFiles", "referenceFastaFiles"):
        shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub))
    return str(dst)


def _records(path, fields=4):
    with open(path) as fh:
        return [ln.split("\t")[:fields] for ln in fh
                if not ln.startswith("@")]


def _model_numbers(path) -> np.ndarray:
    """A model file's transitions, likelihood and emissions."""
    from nanopore_tpu_torch.align.model import PairHmmModel

    m = PairHmmModel.load(path)
    return np.concatenate([m.transitions.ravel(), [m.likelihood],
                           m.emissions.ravel()])


@pytest.fixture(scope="module")
def two_rank_pipeline(tmp_path_factory):
    """The two-rank run's output directory, with the single-process runs
    of the port and the JAX package on copies of its inputs (both run
    while the ranks do)."""
    from test_multihost import _make_working_dir

    from nanopore_tpu.pipeline import PipelineConfig as JaxConfig
    from nanopore_tpu.pipeline import run_pipeline as jax_run_pipeline
    from nanopore_tpu_torch.align.em import EmOptions
    from nanopore_tpu_torch.pipeline import PipelineConfig, run_pipeline

    d = tmp_path_factory.mktemp("two_rank_pipeline")
    wd = _make_working_dir(d)
    solo = _copy_inputs(wd, d / "solo")
    jax_wd = _copy_inputs(wd, d / "jax")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanopore_tpu_torch", "run", wd,
         "--device", "cpu"] + PIPELINE_ARGS,
        env=rank_env(NANOPORE_TPU_COORDINATOR="localhost:%d" % port,
                     NANOPORE_TPU_NUM_PROCESSES="2",
                     NANOPORE_TPU_PROCESS_ID=str(r)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        solo_out = run_pipeline(solo, PipelineConfig(
            mappers=PIPELINE_MAPPERS,
            analyses=["GlobalCoverage", "Substitutions"],
            meta_analyses=["CoverageSummary"], max_workers=2,
            em_options=EmOptions(trials=1, iterations=3), device="cpu"))
        # the chain experiment alone: its mapping.sam is all it is
        # compared on
        jax_out = jax_run_pipeline(jax_wd, JaxConfig(
            mappers=["LastParamsChain"], analyses=[], meta_analyses=[],
            max_workers=2))
    finally:
        wait_all(procs)
    return os.path.join(wd, "output"), solo_out, jax_out


EXPERIMENTS = ["experiment_reads.fq_ref.fa_" + m for m in PIPELINE_MAPPERS]


def test_two_rank_pipeline_outputs(two_rank_pipeline):
    out, _, _ = two_rank_pipeline
    base = os.path.join(out, "analysis_2d")
    assert sorted(os.listdir(base)) == EXPERIMENTS
    for exp in EXPERIMENTS:
        exp_dir = os.path.join(base, exp)
        assert os.path.exists(os.path.join(exp_dir, "mapping.sam"))
        assert not [f for f in os.listdir(exp_dir)
                    if ".shard" in f or ".rshard" in f]
        for analysis in ("GlobalCoverage", "Substitutions"):
            assert os.path.exists(
                os.path.join(exp_dir, "analysis_" + analysis, "DONE"))
    em_dir = os.path.join(base, EXPERIMENTS[1])
    for name in ("hmm.txt", "hmm.txt_unnormalised", "hmm.txt.xml"):
        assert os.path.exists(os.path.join(em_dir, name))
    assert not os.path.exists(os.path.join(em_dir, "hmm.txt.ckpt.npz"))
    assert os.path.isdir(os.path.join(out, "metaAnalysis_CoverageSummary"))
    # each rank ran its strided half of the four analysis tasks, every one
    # on its first attempt
    tasks = {}
    for name in ("pipeline_stats.json", "pipeline_stats.host1.json"):
        with open(os.path.join(out, name)) as fh:
            stats = json.load(fh)
        assert len(stats) == 2
        assert all(v["status"] == "done" and v["attempts"] == 1
                   for v in stats.values())
        tasks.update(stats)
    assert len(tasks) == 4


def test_two_rank_pipeline_chain_sam_equals_single_process(two_rank_pipeline):
    out, solo_out, jax_out = two_rank_pipeline
    rel_sam = os.path.join("analysis_2d", EXPERIMENTS[0], "mapping.sam")
    with open(os.path.join(out, rel_sam)) as fh:
        got = fh.read()
    assert got.count("\n") > 3
    for ref_out in (solo_out, jax_out):
        with open(os.path.join(ref_out, rel_sam)) as fh:
            assert got == fh.read(), ref_out


def test_two_rank_pipeline_em_experiment(two_rank_pipeline):
    out, solo_out, _ = two_rank_pipeline
    rel_dir = os.path.join("analysis_2d", EXPERIMENTS[1])
    got = _records(os.path.join(out, rel_dir, "mapping.sam"))
    assert len(got) == 3
    assert got == _records(os.path.join(solo_out, rel_dir, "mapping.sam"))
    a = _model_numbers(os.path.join(out, rel_dir, "hmm.txt_unnormalised"))
    b = _model_numbers(os.path.join(solo_out, rel_dir,
                                    "hmm.txt_unnormalised"))
    assert a.shape == b.shape == (25 + 1 + 80,)
    assert np.array_equal(a != 0, b != 0)
    assert rel(a[b != 0], b[b != 0]) <= 1e-9


# ---- run_mapper's EM band width on two ranks (ROADMAP C12) ------------- #

C12_DEPTH = dict(trials=1, iterations=2, batch_size=8)


def _c12_paths(wd):
    return (os.path.join(wd, "readFastqFiles", "2d", "reads.fq"),
            os.path.join(wd, "referenceFastaFiles", "ref.fa"))


def c12_worker(rank: int, world: int, port: int, wd: str) -> int:
    import functools

    from nanopore_tpu_torch.align.em import EmOptions
    from nanopore_tpu_torch.mapping import runner
    from nanopore_tpu_torch.parallel import distributed as dist

    dist.initialize_distributed("localhost:%d" % port, world, rank)
    # the runner builds its own options where em_options is None: only
    # their depth is cut, the band width stays the runner's choice
    runner.EmOptions = functools.partial(EmOptions, **C12_DEPTH)
    fq, fa = _c12_paths(wd)
    runner.run_mapper("LastParamsRealignEm", fq, "reads", fa,
                      os.path.join(wd, "ranks.sam"),
                      hmm_file_to_train=os.path.join(wd, "ranks_hmm.txt"),
                      em_options=None, distributed=True, device="cpu")
    dist.barrier("done")
    dist.shutdown_distributed()
    return 0


@pytest.fixture(scope="module")
def c12_models(tmp_path_factory):
    """The two ranks' model (em_options=None), and one process's at band
    widths 32 and 64 (computed while the ranks run)."""
    from test_multihost import _make_working_dir

    from nanopore_tpu_torch.align.em import EmOptions
    from nanopore_tpu_torch.mapping.runner import run_mapper

    wd = _make_working_dir(tmp_path_factory.mktemp("c12"))
    fq, fa = _c12_paths(wd)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "c12", str(r), "2",
         str(port), wd],
        env=rank_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        solo = {}
        for bw in (32, 64):
            hmm = os.path.join(wd, "solo%d_hmm.txt" % bw)
            run_mapper("LastParamsRealignEm", fq, "reads", fa,
                       os.path.join(wd, "solo%d.sam" % bw),
                       hmm_file_to_train=hmm,
                       em_options=EmOptions(band_width=bw, **C12_DEPTH),
                       device="cpu")
            solo[bw] = _model_numbers(hmm + "_unnormalised")
    finally:
        wait_all(procs)
    return _model_numbers(os.path.join(wd, "ranks_hmm.txt_unnormalised")), \
        solo


def test_two_rank_em_without_options_trains_at_the_preset_band(c12_models):
    """Within 1e-9 relative of one process at band width 32 (float64
    sums all-reduced in another order); apart from the model at 64."""
    got, solo = c12_models
    want = solo[32]
    assert got.shape == want.shape == (25 + 1 + 80,)
    assert np.array_equal(got != 0, want != 0)
    assert rel(got[want != 0], want[want != 0]) <= 1e-9
    nz = solo[64] != 0
    assert rel(got[nz], solo[64][nz]) > 1e-6


# ---- the group left at the end of a multi-host run (ROADMAP C13) ------ #

def test_shutdown_distributed_without_a_group_does_nothing():
    import torch.distributed

    from nanopore_tpu_torch.parallel import distributed as dist

    assert not torch.distributed.is_initialized()
    dist.shutdown_distributed()
    dist.shutdown_distributed()
    assert dist.process_info() == (0, 1)


def test_two_ranks_of_run_leave_the_group_and_exit_cleanly(tmp_path):
    """Two ranks of ``python -m nanopore_tpu_torch run --device cpu``
    (one mapper, one analysis), each with its own stderr: both exit 0,
    neither aborts at exit (``run_pipeline`` joins the gloo group and
    ``shutdown_distributed`` leaves it after the last barrier), and the
    experiment's SAM is there."""
    from test_multihost import _make_working_dir

    wd = _make_working_dir(tmp_path)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanopore_tpu_torch", "run", wd,
         "--device", "cpu", "--mappers", "LastParamsChain",
         "--analyses", "GlobalCoverage", "--meta-analyses", "",
         "--max-threads", "1"],
        env=rank_env(NANOPORE_TPU_COORDINATOR="localhost:%d" % port,
                     NANOPORE_TPU_NUM_PROCESSES="2",
                     NANOPORE_TPU_PROCESS_ID=str(r)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("a rank did not finish within %d s" % RANK_TIMEOUT)
        errs.append(err)
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert ABORT not in err, "rank %d aborted at exit:\n%s" % (
            r, err[-4000:])
        assert p.returncode == 0, "rank %d exited %d:\n%s" % (
            r, p.returncode, err[-4000:])
    sam = os.path.join(wd, "output", "analysis_2d",
                       "experiment_reads.fq_ref.fa_LastParamsChain",
                       "mapping.sam")
    assert os.path.exists(sam)


if __name__ == "__main__":
    if sys.argv[1] == "em":
        sys.exit(em_worker(int(sys.argv[2]), int(sys.argv[3]),
                           int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1] == "c12":
        sys.exit(c12_worker(int(sys.argv[2]), int(sys.argv[3]),
                            int(sys.argv[4]), sys.argv[5]))
    sys.exit("unknown worker %r" % sys.argv[1])
