"""The slice as a whole: ``run_mapper`` with every post stage, the
combined mapper and the ``chain`` / ``realign`` / ``em`` / ``modify-hmm``
subcommands, in the port (``device="cpu"``) and in the JAX package, on
one seeded 8-read input (6 kb reference, 260-400 base reads on both
strands: the size the port's plain CPU path serves in seconds).

``LastParamsRealignEm`` (map, chain, Baum-Welch EM, MEA realign with the
trained model; ``EmOptions(trials=2, iterations=3)``): the mapping SAM
and the chained SAM equal, every EM running likelihood rtol 1e-5, the
trained model's files atol 1e-4, the realigned SAM equal field by field.
Wherever SAMs are compared after a realign, a cigar that differs from the
JAX package's XLA scan must be the Pallas kernel's interpret-mode decode
of the same window (tests/test_torch_chain_realign.py).
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from nanopore_tpu import cli as jax_cli
from nanopore_tpu.align.chain_sam import chain_sam_file as jax_chain_sam_file
from nanopore_tpu.align.em import EmOptions as JaxEmOptions
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.mapping.presets import MAPPER_REGISTRY as JAX_PRESETS
from nanopore_tpu.mapping.runner import run_mapper as jax_run_mapper
from nanopore_tpu.mapping.runner import trained_model_path as jax_model_path
from nanopore_tpu_torch import cli
from nanopore_tpu_torch.align.em import EmOptions
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
from nanopore_tpu_torch.mapping.runner import run_mapper
from test_torch_chain_realign import (
    assert_sam_equal_up_to_pallas_ties,
    sam_records,
    write_small_inputs,
)

EM = dict(trials=2, iterations=3, window_pad=64)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_runner")
    fa, fq = write_small_inputs(d, 1)
    # the mapping stage alone, in both packages: the guides of every
    # later comparison
    jax_run_mapper("LastParams", fq, "reads", fa, str(d / "j_map.sam"))
    run_mapper("LastParams", fq, "reads", fa, str(d / "p_map.sam"),
               device="cpu")
    jax_chain_sam_file(str(d / "j_map.sam"), str(d / "j_chain.sam"), fq, fa)
    return {"dir": d, "fa": fa, "fq": fq}


def _traces(xml_path):
    return [[float(v) for v in el.attrib["runningLikelihoods"].split()]
            for el in ET.parse(xml_path).getroot().iter("hmm")]


def test_mapping_and_chained_sams_equal(inputs):
    d = inputs["dir"]
    assert sam_records(str(d / "p_map.sam")) == \
        sam_records(str(d / "j_map.sam"))
    engine = run_mapper("LastParamsChain", inputs["fq"], "reads",
                        inputs["fa"], str(d / "p_chain.sam"), device="cpu")
    assert (d / "p_chain.sam").read_text() == (d / "j_chain.sam").read_text()
    assert engine.stage_stats.snapshot()["post_chain"]["calls"] == 1
    # and through the JAX runner
    jax_run_mapper("LastParamsChain", inputs["fq"], "reads", inputs["fa"],
                   str(d / "j_chain2.sam"))
    assert (d / "j_chain2.sam").read_text() == (d / "p_chain.sam").read_text()


def test_last_params_realign_em_matches_jax(inputs):
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    jax_run_mapper("LastParamsRealignEm", fq, "reads", fa,
                   str(d / "j_em.sam"), str(d / "j.hmm"),
                   JaxEmOptions(use_mesh=False, **EM))
    engine = run_mapper("LastParamsRealignEm", fq, "reads", fa,
                        str(d / "p_em.sam"), str(d / "p.hmm"),
                        EmOptions(batch_size=8, **EM), device="cpu")
    # EM traces: two trials of three iterations, each rtol 1e-5
    pt, jt = _traces(str(d / "p.hmm.xml")), _traces(str(d / "j.hmm.xml"))
    assert [len(t) for t in pt] == [len(t) for t in jt] == [3, 3]
    for a, b in zip(pt, jt):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    # trained model, normalised and not
    for suffix in ("", "_unnormalised"):
        a = PairHmmModel.load(str(d / ("p.hmm" + suffix)))
        b = JaxModel.load(str(d / ("j.hmm" + suffix)))
        np.testing.assert_allclose(a.transitions, b.transitions, atol=1e-4)
        np.testing.assert_allclose(a.emissions, b.emissions, atol=1e-4)
        np.testing.assert_allclose(a.likelihood, b.likelihood, rtol=1e-5)
    # realigned with the trained model
    assert_sam_equal_up_to_pallas_ties(
        str(d / "p_em.sam"), str(d / "j_em.sam"), str(d / "j_chain.sam"), fa,
        JaxModel.load(str(d / "j.hmm")), 0.5, 0.0, 32)
    recs = sam_records(str(d / "p_em.sam"))
    assert len(recs) == 8 and all(r[3] == 0 for r in recs)
    snap = engine.stage_stats.snapshot()
    assert snap["em_e_step"]["calls"] == 6 and snap["em_flank"]["calls"] == 6
    for stage in ("post_chain", "post_em", "post_realign", "wall"):
        assert snap[stage]["calls"] == 1
    assert not (d / "p.hmm.ckpt.npz").exists()


def _run_preset(inputs, name):
    """Run ``name`` in both packages, once per module: (port, jax) SAMs."""
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    port, jax_ = d / ("p_%s.sam" % name), d / ("j_%s.sam" % name)
    if not port.exists():
        jax_run_mapper(name, fq, "reads", fa, str(jax_))
        run_mapper(name, fq, "reads", fa, str(port), device="cpu")
    return str(port), str(jax_)


@pytest.mark.parametrize("name", ["LastParamsRealign",
                                  "LastParamsRealignTrainedModel"])
def test_realign_presets_match_jax(name, inputs):
    port, jax_ = _run_preset(inputs, name)
    spec = JAX_PRESETS[name]
    assert MAPPER_REGISTRY[name].band_width == spec.band_width == 32
    model = (JaxModel.load(jax_model_path(spec.trained_model))
             if spec.trained_model else JaxModel.default())
    assert_sam_equal_up_to_pallas_ties(
        port, jax_, str(inputs["dir"] / "j_chain.sam"), inputs["fa"], model,
        spec.gap_gamma, spec.match_gamma, spec.band_width)


def test_trained_model_changes_the_realign(inputs):
    """The shipped model is really loaded: it moves some cigar."""
    default, _ = _run_preset(inputs, "LastParamsRealign")
    trained, _ = _run_preset(inputs, "LastParamsRealignTrainedModel")
    assert sam_records(default) != sam_records(trained)


def test_combined_mapper_matches_jax(inputs):
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    jax_run_mapper("CombinedMapper", fq, "reads", fa, str(d / "j_comb.sam"))
    run_mapper("CombinedMapper", fq, "reads", fa, str(d / "p_comb.sam"),
               device="cpu")
    got = sam_records(str(d / "p_comb.sam"))
    assert got == sam_records(str(d / "j_comb.sam"))
    assert len({r[0] for r in got}) == 8 and len(got) >= 4 * 8


def _both_cli(argv_jax, argv_port):
    assert jax_cli.main(["--log-level", "WARNING"] + argv_jax) == 0
    assert cli.main(["--log-level", "WARNING"] + argv_port) == 0


def test_cli_chain_and_realign_write_what_the_jax_cli_writes(inputs):
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    src = str(d / "j_map.sam")
    _both_cli(["chain", src, fq, fa, str(d / "jc_chain.sam")],
              ["chain", src, fq, fa, str(d / "pc_chain.sam")])
    assert (d / "pc_chain.sam").read_text() == (d / "jc_chain.sam").read_text()
    hmm = jax_model_path("blasr_hmm_20.txt")
    _both_cli(["realign", src, fq, fa, str(d / "jc_realign.sam"),
               "--hmm", hmm, "--gap-gamma", "0.4"],
              ["realign", src, fq, fa, str(d / "pc_realign.sam"),
               "--hmm", hmm, "--gap-gamma", "0.4", "--device", "cpu"])
    assert_sam_equal_up_to_pallas_ties(
        str(d / "pc_realign.sam"), str(d / "jc_realign.sam"),
        str(d / "j_chain.sam"), fa, JaxModel.load(hmm), 0.4, 0.0, 32)


def test_cli_em_and_modify_hmm_write_what_the_jax_cli_writes(inputs):
    d, fa = inputs["dir"], inputs["fa"]
    chained = str(d / "j_chain.sam")
    _both_cli(["em", chained, fa, str(d / "jc.hmm"), "--trials", "1",
               "--iterations", "2"],
              ["em", chained, fa, str(d / "pc.hmm"), "--trials", "1",
               "--iterations", "2", "--device", "cpu"])
    for suffix in ("", "_unnormalised"):
        a = PairHmmModel.load(str(d / ("pc.hmm" + suffix)))
        b = JaxModel.load(str(d / ("jc.hmm" + suffix)))
        np.testing.assert_allclose(a.transitions, b.transitions, atol=1e-4)
        np.testing.assert_allclose(a.emissions, b.emissions, atol=1e-4)
    np.testing.assert_allclose(_traces(str(d / "pc.hmm.xml")),
                               _traces(str(d / "jc.hmm.xml")), rtol=1e-5)
    args = ["--gc-content", "0.4", "--substitution-rate", "0.1",
            "--flatten-indels"]
    src = str(d / "jc.hmm_unnormalised")
    _both_cli(["modify-hmm", src, str(d / "jm.hmm")] + args,
              ["modify-hmm", src, str(d / "pm.hmm")] + args)
    assert (d / "pm.hmm").read_bytes() == (d / "jm.hmm").read_bytes()


def test_map_cli_takes_hmm_out(inputs):
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    with pytest.raises(ValueError, match="hmm output path"):
        cli.main(["map", fq, fa, str(d / "x.sam"), "--mapper",
                  "LastParamsRealignEm", "--device", "cpu"])


def test_post_stages_raise_without_a_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    for argv in (
        ["map", fq, fa, str(d / "x.sam"), "--mapper", "LastParamsRealign"],
        ["realign", str(d / "j_map.sam"), fq, fa, str(d / "x.sam")],
        ["em", str(d / "j_chain.sam"), fa, str(d / "x.hmm")],
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


def test_unported_runner_paths_name_their_roadmap_item(inputs):
    """The name is kept from when ``distributed=True`` raised (ROADMAP
    A5).  It is ported: in a single process it runs the single-process
    path, whose chained SAM equals the JAX package's (the multi-rank run
    is tests/test_torch_multihost.py's)."""
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    run_mapper("LastParamsChain", fq, "reads", fa, str(d / "dist.sam"),
               distributed=True, device="cpu")
    assert (d / "dist.sam").read_text() == (d / "j_chain.sam").read_text()


def test_viterbi_realign_matches_jax(inputs):
    """``ViterbiRealign``: the Viterbi mapping, chain and MEA realign.
    The Viterbi mapping SAMs equal; the realigned SAM equals the JAX
    package's up to the Pallas ties of the realign, with the JAX
    package's chain of its own Viterbi mapping as the guides."""
    d, fa, fq = inputs["dir"], inputs["fa"], inputs["fq"]
    port, jax_ = _run_preset(inputs, "ViterbiRealign")
    p_map, j_map = _run_preset(inputs, "Viterbi")
    assert sam_records(p_map) == sam_records(j_map)
    jax_chain_sam_file(j_map, str(d / "j_vit_chain.sam"), fq, fa)
    spec = JAX_PRESETS["ViterbiRealign"]
    assert spec.config.decode == MAPPER_REGISTRY["ViterbiRealign"].config.decode
    assert_sam_equal_up_to_pallas_ties(
        port, jax_, str(d / "j_vit_chain.sam"), fa, JaxModel.default(),
        spec.gap_gamma, spec.match_gamma, spec.band_width)
    recs = sam_records(port)
    assert len(recs) == 8 and all(r[3] == 0 for r in recs)
