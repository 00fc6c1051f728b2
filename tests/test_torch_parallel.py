"""The port's parallel layer (``parallel/``, ``EmOptions(use_mesh=True)``,
``ops.dispatch.local_dp_devices``) in one process, on the CPU, against
the JAX package's.

* ``mesh_shape`` on tests/test_parallel.py's cases against the JAX
  ``make_mesh`` over the same device counts; ``make_mesh``, the barrier
  and the coordinator's decision in one process (a 1 x 1 mesh, no-ops).
* ``host_shard`` and ``shard_paths`` equal to the JAX package's.
* ``merge_sam_shards`` in both orders, and with an unsorted shard (the
  in-memory fallback): byte-identical to the JAX function on the same
  shard files, which both remove.
* ``EmOptions(use_mesh=True)`` in one process (a 1 x 1 mesh) at W = 64
  with window pad 16 and flank corrections, 2 trials x 3 iterations:
  within 1e-9 relative of the port's ``em_train`` (the same float64 sums
  in another order), and at tests/test_torch_em.py's bar (atol 1e-4 on
  table entries, rtol 1e-5 on likelihoods and traces) of the JAX
  ``_em_train_sharded`` on its 8-device CPU mesh (4 x 2).  The
  convergence tolerance, 0.22, sits between the two trials' relative
  change at the second iteration (0.203 and 0.242), so trial 0 converges
  there and freezes while trial 1 takes a third.
* A ``"sharded"`` checkpoint written by the JAX package, killed after
  its second iteration, resumed by the port: the uninterrupted port
  run's models at the EM bar.
* ``local_dp_devices`` patched to two CPU devices in the mapping engine,
  the realign stage and the E-step: each device gets batches, and the
  outputs are those of one device.
"""

import os

import numpy as np
import pytest
import torch

from nanopore_tpu.align import em as jax_em
from nanopore_tpu.io.sam import SamReader as JaxSamReader
from nanopore_tpu.parallel import distributed as jax_dist
from nanopore_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nanopore_tpu_torch.align import em
from nanopore_tpu_torch.align import realign as realign_mod
from nanopore_tpu_torch.io.encoding import decode, revcomp_codes
from nanopore_tpu_torch.io.sam import SamRecord, SamWriter
from nanopore_tpu_torch.mapping import engine as engine_mod
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import (
    MapperConfig,
    MappingEngine,
    StageStats,
)
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.parallel import distributed as dist
from nanopore_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from test_torch_multihost import (
    EM_OPTS,
    assert_close_at,
    assert_em_bar,
    em_pairs,
    result_arrays,
)

TRIALS = 2


# ---- mesh and host helpers -------------------------------------------- #

@pytest.mark.parametrize("n,trials", [(8, 2), (8, 3), (7, 3)])
def test_mesh_shape_matches_jax(n, trials):
    shape = jax_make_mesh(n_devices=n, n_trials=trials).shape
    assert mesh_shape(n, trials) == (shape["dp"], shape["trial"])


def test_one_process_mesh_and_collectives_are_trivial():
    assert not torch.distributed.is_initialized()
    assert dist.initialize_distributed() == (0, 1)  # no coordinator set
    assert dist.process_info() == (0, 1) and dist.is_coordinator()
    mesh = make_mesh(n_trials=3)
    assert mesh.shape == {"dp": 1, "trial": 1} and mesh.coords == (0, 0)
    assert mesh.dp_group is None and mesh.trial_group is None
    dist.barrier("anything")
    assert dist.coordinator_decision(True) is True
    assert dist.coordinator_decision(False) is False


@pytest.mark.parametrize("pi,pc", [(0, 1), (1, 3), (2, 3)])
def test_host_shard_and_shard_paths_match_jax(pi, pc):
    items = list(range(11))
    assert dist.host_shard(items, pi, pc) == jax_dist.host_shard(
        items, pi, pc)
    assert dist.shard_paths("out.sam", pc) == jax_dist.shard_paths(
        "out.sam", pc)


def _write_shards(d, order):
    """Three SAM shards of one record list: strided (as the mapper and
    the realign stage shard), each sorted by ``sort_key`` unless
    ``order`` is "unsorted" (shard 1 reversed)."""
    rng = np.random.default_rng(4)
    refs = {"chrA": 900, "chrB": 700}
    recs = [SamRecord(qname="r%02d" % i, flag=int(rng.choice([0, 16])),
                      rname=str(rng.choice(list(refs))),
                      pos=int(rng.integers(0, 600)), mapq=60,
                      cigar=[(0, 20)], seq="ACGT" * 5) for i in range(20)]
    paths = []
    for i in range(3):
        shard = recs[i::3]
        if order != "interleave":
            shard.sort(key=SamRecord.sort_key)
        if order == "unsorted" and i == 1:
            shard.reverse()
        paths.append(str(d / ("out.sam.shard%d" % i)))
        with SamWriter(paths[-1], refs) as w:
            for rec in shard:
                w.write(rec)
    return paths


@pytest.mark.parametrize("order", ["sorted", "interleave", "unsorted"])
def test_merge_sam_shards_matches_jax(order, tmp_path):
    mode = "interleave" if order == "interleave" else "sorted"
    got = {}
    for name, merge in (("port", dist.merge_sam_shards),
                        ("jax", jax_dist.merge_sam_shards)):
        d = tmp_path / name
        d.mkdir()
        paths = _write_shards(d, order)
        n = merge(paths, str(d / "out.sam"), order=mode)
        assert n == 20
        assert not [p for p in paths if os.path.exists(p)]
        got[name] = (d / "out.sam").read_bytes()
    assert got["port"] == got["jax"]
    recs = list(JaxSamReader(str(tmp_path / "port" / "out.sam")))
    if mode == "sorted":
        assert [r.sort_key() for r in recs] == sorted(
            r.sort_key() for r in recs)
    else:
        assert [r.qname for r in recs] == ["r%02d" % i for i in range(20)]


# ---- sharded EM in one process ---------------------------------------- #

@pytest.fixture(scope="module")
def em_runs():
    stats = StageStats()
    sharded = em.em_train(em_pairs(), em.EmOptions(
        use_mesh=True, trials=TRIALS, **EM_OPTS), device="cpu", stats=stats)
    single = em.em_train(em_pairs(), em.EmOptions(
        use_mesh=False, trials=TRIALS, **EM_OPTS), device="cpu")
    jax_sharded = jax_em.em_train(em_pairs(), jax_em.EmOptions(
        use_mesh=True, trials=TRIALS, **EM_OPTS))
    return {"sharded": result_arrays(sharded), "single": result_arrays(single),
            "jax": jax_sharded, "stats": stats.snapshot()}


def test_use_mesh_in_one_process_equals_em_train(em_runs):
    assert_close_at(em_runs["sharded"], em_runs["single"], 1e-9)


def test_use_mesh_in_one_process_matches_jax_sharded(em_runs):
    assert jax_make_mesh(n_trials=TRIALS).shape == {"dp": 4, "trial": 2}
    assert_em_bar(em_runs["sharded"], em_runs["jax"])


def test_per_trial_convergence_freezes_the_converged_trial(em_runs):
    """Trial 0 converges at its second iteration: its trace stops there
    and it is not stepped again, while trial 1 takes a third iteration;
    trial 0's model is the one em_train (which trains the trials one
    after another) stops at."""
    got = em_runs["sharded"]
    assert [len(t) for t in got["traces"]] == [2, 3]
    t0, t1 = got["traces"]
    tol = EM_OPTS["convergence_tol"]
    assert abs(t0[1] - t0[0]) <= tol * abs(t0[0])
    assert abs(t1[1] - t1[0]) > tol * abs(t1[0])
    for stage in ("em_e_step", "em_m_step"):
        assert em_runs["stats"][stage]["calls"] == 5
    want = em_runs["single"]
    assert got["traces"][0] == pytest.approx(want["traces"][0], rel=1e-9)
    for key in ("t", "e"):
        nz = want[key][0] != 0
        np.testing.assert_allclose(got[key][0][nz], want[key][0][nz],
                                   rtol=1e-9)


def test_sharded_checkpoint_written_by_jax_resumes_in_the_port(
        em_runs, tmp_path, monkeypatch):
    ck = str(tmp_path / "em.ckpt.npz")
    kw = dict(use_mesh=True, trials=TRIALS, checkpoint_path=ck,
              checkpoint_every=1, **EM_OPTS)
    real = jax_em.save_em_checkpoint
    saves = []

    class Killed(Exception):
        pass

    def save_then_die(path, state):
        real(path, state)
        saves.append(state["iteration"])
        if len(saves) == 2:
            raise Killed()

    monkeypatch.setattr(jax_em, "save_em_checkpoint", save_then_die)
    with pytest.raises(Killed):
        jax_em.em_train(em_pairs(), jax_em.EmOptions(**kw))
    state = em.load_em_checkpoint(ck)
    assert state["format"] == "sharded" and state["iteration"] == 2
    assert state["converged"].tolist() == [True, False]
    stats = StageStats()
    resumed = em.em_train(em_pairs(), em.EmOptions(**kw), device="cpu",
                          stats=stats)
    assert stats.snapshot()["em_e_step"]["calls"] == 1  # trial 1's third
    assert_em_bar(result_arrays(resumed), em_runs["jax"])
    got = result_arrays(resumed)
    want = em_runs["sharded"]
    for g, w in zip(got["traces"], want["traces"]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-4)
    np.testing.assert_allclose(got["e"], want["e"], atol=1e-4)
    assert not os.path.exists(ck)


# ---- the round-robin over local devices ------------------------------- #

def test_local_dp_devices_lists_every_local_card(monkeypatch):
    assert dispatch.local_dp_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dispatch.local_dp_devices("cuda:0") == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert dispatch.local_dp_devices("cuda:0") == [
        torch.device("cuda", i) for i in range(3)]


def _two_devices(monkeypatch, module):
    """Patch ``module.local_dp_devices`` to two CPU devices (a string and
    a torch.device, so each batch's device can be told apart) and record
    the device each batch is prepared on."""
    used = []
    real = module.prepared_from_pairs

    def prepared(cls_kwargs, *args, **kwargs):
        used.append(type(cls_kwargs["device"]).__name__)
        return real(cls_kwargs, *args, **kwargs)

    monkeypatch.setattr(module, "local_dp_devices",
                        lambda device: ["cpu", torch.device("cpu")])
    monkeypatch.setattr(module, "prepared_from_pairs", prepared)
    return used


def _map(tmp_path):
    """A 1,200-base reference and two 150-base reads, one on each
    strand, mapped one candidate a batch."""
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 4, 1200).astype(np.int8)
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    fa.write_text(">chrT\n%s\n" % decode(ref))
    lines = []
    for r, start in enumerate((200, 800)):
        y = ref[start:start + 150].copy()
        y[rng.integers(0, 150, 5)] = rng.integers(0, 4, 5)
        y = revcomp_codes(y) if r else y
        lines.append("@read_%d\n%s\n+\n%s\n" % (r, decode(y), "I" * 150))
    fq.write_text("".join(lines))
    engine = MappingEngine(read_fasta_dict(str(fa)),
                           MapperConfig(batch_size=1, band_width=32),
                           device="cpu")
    out = tmp_path / "out.sam"
    assert engine.map_fastq(str(fq), str(out)) >= 2
    return out.read_text()


def _realign(records, ref):
    """The realigned cigars of ``records``, one record a batch."""
    realign_mod.realign_records(records, ref, band_width=32, batch_size=1,
                                device="cpu")
    return [r.cigar for r in records]


def _global_records():
    pairs = em_pairs(count=2, n_ref=200)
    ref = {"ref": decode(pairs[0][0])}
    return [SamRecord(qname="q%d" % i, flag=0, rname="ref", pos=0, mapq=60,
                      cigar=list(guide), seq=decode(y))
            for i, (_, y, guide) in enumerate(pairs)], ref


def _e_step():
    preps = em.prepare_batches(em_pairs(count=2), 64, 1, torch.device("cpu"))
    return em._e_step(preps, em.make_kernel_params(em.PairHmmModel.default()),
                      torch.device("cpu"), None)


@pytest.mark.parametrize("stage", ["engine", "realign", "e_step"])
def test_two_local_devices_give_one_devices_outputs(stage, tmp_path,
                                                    monkeypatch):
    module, run = {
        "engine": (engine_mod, lambda: _map(tmp_path)),
        "realign": (realign_mod, lambda: _realign(*_global_records())),
        "e_step": (em, _e_step),
    }[stage]
    want = run()
    with monkeypatch.context() as mp:
        used = _two_devices(mp, module)
        got = run()
    if stage == "e_step":
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    else:
        assert got == want
    # the batches alternate between the two devices
    assert len(used) >= 2 and set(used) == {"str", "device"}
