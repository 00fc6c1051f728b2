"""Combined scatter / trend paper-figure plots.

A copy of the JAX package's ``scripts/scatter_plots.py``.

Replaces three standalone reference R scripts:

- ``make_scatter_plot.R``: two colour-coded scatter pages from a
  summary table with columns ``AvgInsert``, ``AvgDelete``,
  ``avgMismatch`` and experiment row names (mismatch-vs-indel and
  insertions-vs-deletions; reference make_scatter_plot.R:13-17).
- ``combined_plots.R``: seven density-scatter panels over the per-read
  distribution lines (``length``/``mismatches``/``identity``/
  ``deletions``/``insertions`` rows, whitespace-separated — the
  distribution file format the coverage analyses emit), each with a
  linear trend fit over 2-sigma inliers and its adjusted R-squared in
  the legend (combined_plots.R:25-106).
- ``combine_plots_remove_trends.R``: the same panels without the trend
  lines (``--no-trends``).

Usage:
  python -m nanopore_tpu_torch.scripts.scatter_plots summary table.tsv out.pdf
  python -m nanopore_tpu_torch.scripts.scatter_plots combined dist.txt out.pdf
      [--no-trends]
"""

from __future__ import annotations

import sys

import numpy as np

from nanopore_tpu_torch.analyses.plots import HAVE_MPL


def _adj_r2(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, float]:
    """(poly coefficients, adjusted R^2) of the degree-1 fit —
    summary.lm(...)$adj.r.squared semantics."""
    coef = np.polyfit(x, y, 1)
    resid = y - np.polyval(coef, x)
    ss_tot = ((y - y.mean()) ** 2).sum()
    r2 = 1.0 - resid @ resid / ss_tot if ss_tot > 0 else 0.0
    n = len(x)
    adj = 1.0 - (1.0 - r2) * (n - 1) / max(n - 2, 1)
    return coef, adj


def scatter_summary_plot(table_path: str, out_pdf: str) -> None:
    """make_scatter_plot.R: mismatch-vs-indel + ins-vs-del scatters."""
    if not HAVE_MPL:  # pragma: no cover
        return
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    names: list[str] = []
    rows: list[list[float]] = []
    with open(table_path) as fh:
        header = fh.readline().split()
        for line in fh:
            parts = line.split()
            names.append(parts[0])
            rows.append([float(v) for v in parts[1:]])
    col = {h: i for i, h in enumerate(header)}
    m = np.array(rows)
    ins = m[:, col["AvgInsert"]]
    dele = m[:, col["AvgDelete"]]
    mism = m[:, col["avgMismatch"]]
    # reference styling: 3 markers cycling, colour per group of 3 rows
    markers = ["s", "o", "^"]
    colors = ["#e41a1c", "#4daf4a", "#377eb8", "#000000"]
    with PdfPages(out_pdf) as pdf:
        for xs, ys, xl, yl, title, corner in [
            (ins + dele, mism, "Average Indel Rate",
             "Average Mismatch Rate", "Mismatch vs. Indel", "upper right"),
            (ins, dele, "Average Insertions Per Aligned Read Base",
             "Avg Deletions Per Aligned Read Base",
             "Insertions vs. Deletions", "lower right"),
        ]:
            fig, ax = plt.subplots(figsize=(7, 6))
            for i, name in enumerate(names):
                ax.scatter(
                    xs[i], ys[i], s=70, marker=markers[i % 3],
                    color=colors[(i // 3) % 4], alpha=0.7, label=name,
                )
            ax.set_xlabel(xl)
            ax.set_ylabel(yl)
            ax.set_title(title)
            ax.legend(fontsize=6, loc=corner)
            pdf.savefig(fig)
            plt.close(fig)


_PANELS = [
    # (x key, y key(s), x label, y label, title)
    ("length", ("identity",), "Read Length", "Read Identity",
     "Read Identity vs. Read Length"),
    ("length", ("insertions", "deletions"), "Read Length",
     "Indels Per Base", "Indels Per Aligned Base vs. Read Length"),
    ("length", ("mismatches",), "Read Length",
     "Mismatches Per Aligned Base",
     "Mismatches Per Aligned Base vs. Read Length"),
    (("insertions", "deletions"), ("mismatches",),
     "Indels Per Aligned Base", "Mismatches Per Aligned Base",
     "Mismatches vs. Indels Per Aligned Base"),
    ("identity", ("insertions", "deletions"), "Read Identity",
     "Indels Per Base", "Indels Per Aligned Base vs. Read Identity"),
    ("identity", ("mismatches",), "Read Identity",
     "Mismatches Per Aligned Base",
     "Mismatches Per Aligned Base vs. Read Identity"),
    ("deletions", ("insertions",), "Deletions Per Aligned Base",
     "Insertions Per Aligned Base", "Insertions vs. Deletions"),
]


def combined_plots(
    dist_path: str, out_pdf: str, trends: bool = True
) -> None:
    """combined_plots.R / combine_plots_remove_trends.R panels."""
    if not HAVE_MPL:  # pragma: no cover
        return
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    data: dict[str, np.ndarray] = {}
    with open(dist_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) > 1:
                data[parts[0]] = np.array([float(v) for v in parts[1:]])

    # 2-sigma inliers on EVERY series jointly, as the R script's
    # intersected inlier index (combined_plots.R:25-31)
    all_keys = ["length", "mismatches", "identity", "deletions",
                "insertions"]
    nmin = min(len(data[k]) for k in all_keys)

    def series(key) -> np.ndarray:
        # trim each row to the common length BEFORE summing: rows of a
        # hand-edited distributions file can disagree in value count
        if isinstance(key, tuple):
            return sum(data[k][:nmin] for k in key)
        return data[key][:nmin]
    mask = np.ones(nmin, bool)
    for k in all_keys:
        v = data[k][:nmin]
        mask &= np.abs(v - v.mean()) <= 2 * v.std()

    with PdfPages(out_pdf) as pdf:
        for page in (0, 1):
            panels = _PANELS[:3] if page == 0 else _PANELS[3:]
            fig, axes = plt.subplots(2, 2, figsize=(10, 9))
            for ax in axes.flat[len(panels):]:
                ax.axis("off")
            for ax, (xk, yk, xl, yl, title) in zip(axes.flat, panels):
                x = series(xk)[:nmin]
                y = series(yk)[:nmin]
                # density scatter (panel.smoothScatter analogue)
                ax.hexbin(x, y, gridsize=40, cmap="Blues", mincnt=1)
                if trends and mask.sum() > 2:
                    coef, adj = _adj_r2(x[mask], y[mask])
                    xs = np.linspace(x.min(), x.max(), 50)
                    ax.plot(xs, np.polyval(coef, xs), "k-", lw=1.2)
                    ax.text(
                        0.97, 0.97, "R^2 = %.3f" % adj,
                        transform=ax.transAxes, ha="right", va="top",
                        fontsize=8,
                    )
                ax.set_xlabel(xl)
                ax.set_ylabel(yl)
                ax.set_title(title, fontsize=9)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 2
    mode, inp, out = argv[0], argv[1], argv[2]
    if mode == "summary":
        scatter_summary_plot(inp, out)
    elif mode == "combined":
        combined_plots(inp, out, trends="--no-trends" not in argv[3:])
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
