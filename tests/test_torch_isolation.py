"""The PyTorch/CUDA port imports neither JAX nor the JAX package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "nanopore_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1] == "__main__":
            continue
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "nanopore_tpu_torch.ops.realign" in mods
    code = (
        "import importlib, sys\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'nanopore_tpu' or "
        "m.startswith('nanopore_tpu.'))\n"
        "print(repr(bad))\n" % (mods,)
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_source_names_no_jax_or_reference_import():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+nanopore_tpu\.|"
        r"from\s+nanopore_tpu\.|import\s+nanopore_tpu\s*$|"
        r"from\s+nanopore_tpu\s+import)",
        re.M,
    )
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "realign_ab.py"]
    offenders = [
        str(p.relative_to(ROOT)) for p in files
        if pattern.search(p.read_text())
    ]
    assert offenders == []


PIPELINE_MODULES = [
    "nanopore_tpu_torch.ops.reductions",
    "nanopore_tpu_torch.analyses.substitutions",
    "nanopore_tpu_torch.analyses.coverage",
    "nanopore_tpu_torch.analyses.indels",
    "nanopore_tpu_torch.analyses.kmer",
    "nanopore_tpu_torch.analyses.channel",
    "nanopore_tpu_torch.analyses.hmm_analysis",
    "nanopore_tpu_torch.analyses.consensus",
    "nanopore_tpu_torch.analyses.qc",
    "nanopore_tpu_torch.analyses.read_sampler",
    "nanopore_tpu_torch.meta",
    "nanopore_tpu_torch.meta.base",
    "nanopore_tpu_torch.meta.unmapped",
    "nanopore_tpu_torch.meta.coverage_summary",
    "nanopore_tpu_torch.meta.hmm_meta",
    "nanopore_tpu_torch.runtime.scheduler",
    "nanopore_tpu_torch.pipeline",
]

# the host modules that complete the port of the JAX package's
# io/, meta/ and scripts/
HOST_MODULES = [
    "nanopore_tpu_torch.io.cigar",
    "nanopore_tpu_torch.io.bam",
    "nanopore_tpu_torch.io.twobit",
    "nanopore_tpu_torch.meta.coverage_depth",
    "nanopore_tpu_torch.meta.margin_align_meta",
    "nanopore_tpu_torch.meta.assembly_hub",
    "nanopore_tpu_torch.scripts.textable",
    "nanopore_tpu_torch.scripts.blast_tex",
    "nanopore_tpu_torch.scripts.variant_table",
    "nanopore_tpu_torch.scripts.pull_averages",
    "nanopore_tpu_torch.scripts.extract_coverage_xmls",
    "nanopore_tpu_torch.scripts.mappability_plots",
    "nanopore_tpu_torch.scripts.scatter_plots",
    "nanopore_tpu_torch.scripts.blast_unmapped",
    "nanopore_tpu_torch.scripts.rescue_2d",
]

# the parallel layer (the multi-host run)
PARALLEL_MODULES = [
    "nanopore_tpu_torch.parallel",
    "nanopore_tpu_torch.parallel.distributed",
    "nanopore_tpu_torch.parallel.mesh",
    "nanopore_tpu_torch.parallel.sharded_em",
]


def test_the_pipeline_modules_are_imported_and_their_sources_checked():
    """Both checks above walk the package, so they cover the pipeline's
    modules, the host modules and the parallel layer; this holds that
    they do."""
    mods = _port_modules()
    checked = PIPELINE_MODULES + HOST_MODULES + PARALLEL_MODULES
    missing = [m for m in checked if m not in mods]
    assert missing == []
    for m in checked:
        rel = pathlib.Path(*m.split("."))
        path = ROOT / rel.with_suffix(".py")
        if not path.exists():
            path = ROOT / rel / "__init__.py"
        assert path in set(PKG.rglob("*.py")), m
