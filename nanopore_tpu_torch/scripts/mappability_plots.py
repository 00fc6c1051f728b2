"""Flowcell-layout channel mappability heatmaps.

A copy of the JAX package's ``scripts/mappability_plots.py``.

Replaces the standalone paper-figure script
the reference's scripts/mappability_plots.R: for each
``channel_mappability.tsv`` (written by analyses.channel) it renders the
512 MinION channels at their PHYSICAL flowcell positions — a 32-row x
16-column grid of 4 column-blocks (the hard-coded ``labels`` table at
mappability_plots.R:5-36 follows the closed form
``channel(r, c) = 128*(c//4) + (124 - 4*r) + c%4 + 1``, verified against
every entry) — as white-to-red level plots of total reads, mapped reads,
and mapped fraction per channel (three pages, one panel per input, like
the R script's three ``levelplot`` grids).

The R script divides ``data[j, i] / data[j+1, i+1]`` for the fraction
page (mappability_plots.R:115) — an off-by-one that pairs channel j's
mapped count with channel j+1's total; here the fraction is
``mapped[j] / total[j]`` as evidently intended.

Usage: python -m nanopore_tpu_torch.scripts.mappability_plots out.pdf \
           label1=path/channel_mappability.tsv [label2=...]
"""

from __future__ import annotations

import sys

import numpy as np

from nanopore_tpu_torch.analyses.plots import HAVE_MPL


def flowcell_layout() -> np.ndarray:
    """(32, 16) array of 1-based channel numbers at physical positions
    (closed form of the R ``labels`` table)."""
    r = np.arange(32)[:, None]
    c = np.arange(16)[None, :]
    return 128 * (c // 4) + (124 - 4 * r) + (c % 4) + 1


def read_channel_tsv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(total (512,), mapped (512,)) indexed by channel-1."""
    total = np.zeros(512)
    mapped = np.zeros(512)
    with open(path) as fh:
        header = fh.readline()
        assert "Channel" in header, "not a channel_mappability.tsv"
        for line in fh:
            parts = line.split()
            ch = int(parts[0])
            if 1 <= ch <= 512:
                total[ch - 1] = float(parts[1])
                mapped[ch - 1] = float(parts[2])
    return total, mapped


def _grids(values: np.ndarray) -> np.ndarray:
    """Scatter per-channel values onto the flowcell layout grid."""
    grid = np.zeros((32, 16))
    lay = flowcell_layout()
    grid[:, :] = values[lay - 1]
    return grid


def mappability_plots(
    out_pdf: str, inputs: list[tuple[str, str]]
) -> None:
    """Render the three heatmap pages for the labelled TSVs."""
    if not HAVE_MPL:  # pragma: no cover
        return
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list(
        "wr", ["white", "red"], N=256
    )
    data = [(label, *read_channel_tsv(path)) for label, path in inputs]
    pages = [
        ("total reads", [(lab, t) for lab, t, _ in data], None),
        ("mapped reads", [(lab, m) for lab, _, m in data], None),
        (
            "mapped fraction",
            [
                (
                    lab,
                    np.where(t > 0, m / np.maximum(t, 1), 0.0),
                )
                for lab, t, m in data
            ],
            (0.0, 1.0),
        ),
    ]
    with PdfPages(out_pdf) as pdf:
        for title, series, vrange in pages:
            n = len(series)
            cols = min(3, n)
            rows = -(-n // cols)
            fig, axes = plt.subplots(
                rows, cols, figsize=(4 * cols, 6 * rows), squeeze=False
            )
            vmax = (
                vrange[1]
                if vrange
                else max(1e-9, max(v.max() for _, v in series))
            )
            vmin = vrange[0] if vrange else 0.0
            for ax in axes.flat[n:]:
                ax.axis("off")
            for ax, (label, values) in zip(axes.flat, series):
                im = ax.imshow(
                    _grids(values), cmap=cmap, vmin=vmin, vmax=vmax,
                    aspect="auto",
                )
                ax.set_title("%s\n%s" % (label, title), fontsize=8)
                ax.set_xticks([])
                ax.set_yticks([])
                fig.colorbar(im, ax=ax, shrink=0.6)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    out_pdf = argv[0]
    inputs = []
    for arg in argv[1:]:
        label, _, path = arg.partition("=")
        if not path:
            label, path = arg, arg
        inputs.append((label, path))
    mappability_plots(out_pdf, inputs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
