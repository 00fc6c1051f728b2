"""Plotting layer: matplotlib replacements for the reference's R scripts.

A copy of the JAX package's ``analyses/plots.py``.  The reference shells
out to 20 R scripts (1511 LoC) for all plots and the only out-of-Python
statistics (SURVEY.md section 2, Lx layer).  Each function here replaces
one ``Rscript`` invocation site and writes the same output file; the
k-mer significance test (kmer_analysis.R:16-52) is the resampled KS
statistic above the reference's data-size gate and a two-proportion
z-test below it.

All plotting is defensive: a plotting failure must never fail an
analysis (the data files are the contract; plots are a convenience),
and without matplotlib nothing is drawn.  ``kmer_significance`` writes
its p-value tables either way.
"""

from __future__ import annotations

import logging
import math

import numpy as np

logger = logging.getLogger("nanopore_tpu_torch")

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except Exception:  # pragma: no cover
    HAVE_MPL = False


def _safe(fn):
    def wrapper(*args, **kwargs):
        if not HAVE_MPL:
            return
        try:
            fn(*args, **kwargs)
        except Exception as exc:  # pragma: no cover
            logger.warning("plot %s failed: %s", fn.__name__, exc)

    wrapper.__name__ = fn.__name__
    return wrapper


@_safe
def substitution_plot(tsv_path: str, pdf_path: str, title: str) -> None:
    """Heatmap of the 4x4 substitution frequency matrix
    (substitution_plot.R)."""
    with open(tsv_path) as fh:
        header = fh.readline().split()
        rows, labels = [], []
        for line in fh:
            parts = line.split()
            labels.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    m = np.array(rows)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(m, cmap="viridis", vmin=0, vmax=max(1e-9, m.max()))
    ax.set_xticks(range(len(header)), header)
    ax.set_yticks(range(len(labels)), labels)
    ax.set_xlabel("read base")
    ax.set_ylabel("reference base")
    ax.set_title(title)
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            ax.text(j, i, "%.3f" % m[i, j], ha="center", va="center",
                    color="white" if m[i, j] < 0.5 * m.max() else "black",
                    fontsize=8)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)


@_safe
def coverage_plot(txt_path: str, pdf_path: str) -> None:
    """Distributions + length-vs-identity trend (coverage_plot.R)."""
    data = {}
    with open(txt_path) as fh:
        for line in fh:
            parts = line.split()
            data[parts[0]] = np.array([float(x) for x in parts[1:]])
    fig, axes = plt.subplots(2, 3, figsize=(12, 7))
    panels = [
        ("ReadIdentity", "identity"),
        ("ReadCoverage", "read coverage"),
        ("MismatchesPerReadBase", "mismatches/base"),
        ("InsertionsPerBase", "insertions/base"),
        ("DeletionsPerBase", "deletions/base"),
    ]
    for ax, (key, label) in zip(axes.flat, panels):
        vals = data.get(key, np.array([]))
        vals = vals[np.isfinite(vals)]
        if len(vals):
            ax.hist(vals, bins=min(30, max(3, len(vals))), color="#3b6fb6")
        ax.set_xlabel(label)
        ax.set_ylabel("alignments")
    ax = axes.flat[5]
    lengths = data.get("MappedReadLengths", np.array([]))
    ident = data.get("ReadIdentity", np.array([]))
    if len(lengths) == len(ident) and len(lengths) > 1:
        ok = np.isfinite(ident)
        ax.scatter(lengths[ok], ident[ok], s=8, alpha=0.6)
        if ok.sum() > 2:
            coef = np.polyfit(lengths[ok], ident[ok], 1)
            xs = np.linspace(lengths[ok].min(), lengths[ok].max(), 50)
            resid = ident[ok] - np.polyval(coef, lengths[ok])
            ss_tot = ((ident[ok] - ident[ok].mean()) ** 2).sum()
            r2 = 1 - (resid**2).sum() / ss_tot if ss_tot > 0 else 0.0
            ax.plot(xs, np.polyval(coef, xs), "r-", lw=1,
                    label="fit R^2=%.3f" % r2)
            ax.legend(fontsize=7)
    ax.set_xlabel("read length")
    ax.set_ylabel("identity")
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)


@_safe
def indel_plots(tsv_path: str, pdf_path: str) -> None:
    """Indel length and per-read count distributions (indelPlots.R)."""
    with open(tsv_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        cols = {h: [] for h in header}
        for line in fh:
            for h, v in zip(header, line.rstrip("\n").split("\t")):
                if v not in ("None", ""):
                    try:
                        cols[h].append(float(v))
                    except ValueError:
                        pass
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    for ax, key, label in (
        (axes[0][0], "readInsertionLengths", "insertion length"),
        (axes[0][1], "readDeletionLengths", "deletion length"),
        (axes[1][0], "NumberReadInsertions", "insertions per read"),
        (axes[1][1], "NumberReadDeletions", "deletions per read"),
    ):
        vals = np.array(cols.get(key, []))
        if len(vals):
            ax.hist(vals, bins=min(40, max(3, len(vals))), color="#b63b3b",
                    log=key.startswith("read"))
        ax.set_xlabel(label)
        ax.set_ylabel("count")
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)


def _kolmogorov_sf(t: np.ndarray) -> np.ndarray:
    """Asymptotic two-sample KS p-value: P(sqrt(n_eff) D > t)
    = 2 sum_{k>=1} (-1)^{k-1} exp(-2 k^2 t^2) — the statistic R's
    ks.test(exact=FALSE) computes (1 - C_pKS2)."""
    try:
        from scipy.special import kolmogorov

        return np.clip(kolmogorov(t), 0.0, 1.0)
    except Exception:  # pragma: no cover
        t = np.asarray(t, np.float64)
        k = np.arange(1, 101)[:, None]
        terms = (-1.0) ** (k - 1) * np.exp(-2.0 * k**2 * t[None, :] ** 2)
        p = 2.0 * terms.sum(0)
        return np.where(t < 0.05, 1.0, np.clip(p, 0.0, 1.0))


def resampled_ks_pvalues(
    ref_frac: np.ndarray,
    read_frac: np.ndarray,
    num_trials: int = 1000,
    trial_size: int = 5000,
    seed: int = 0,
) -> np.ndarray:
    """The reference's k-mer significance statistic (kmer_analysis.R:16-33).

    For each of the n k-mers: draw ``num_trials`` multinomial samples of
    ``trial_size`` draws from the reference-fraction distribution and
    the read-fraction distribution, then two-sample KS-test the two
    per-kmer count samples (asymptotic p, as R chooses for
    1000x1000 >= 10000).  Vectorised: one multinomial per side, ECDFs by
    bincount + cumsum.  RNG is seeded numpy rather than R's — sampling
    noise differs, the statistic is the same.
    """
    n = len(ref_frac)
    rng = np.random.default_rng(seed)
    ref_p = np.maximum(np.asarray(ref_frac, np.float64), 0)
    read_p = np.maximum(np.asarray(read_frac, np.float64), 0)
    if ref_p.sum() <= 0 or read_p.sum() <= 0:
        return np.ones(n)
    ref_p /= ref_p.sum()
    read_p /= read_p.sum()
    ref_s = rng.multinomial(trial_size, ref_p, size=num_trials)  # (T, n)
    read_s = rng.multinomial(trial_size, read_p, size=num_trials)
    vmax = int(max(ref_s.max(), read_s.max())) + 1
    cols = np.broadcast_to(np.arange(n), (num_trials, n)).ravel()

    def ecdf(mat):
        h = np.bincount(
            cols * vmax + mat.ravel(), minlength=n * vmax
        ).reshape(n, vmax)
        return np.cumsum(h, axis=1) / num_trials

    d = np.abs(ecdf(ref_s) - ecdf(read_s)).max(axis=1)  # (n,)
    n_eff = num_trials / 2.0  # n*m/(n+m) with n=m=num_trials
    return _kolmogorov_sf(np.sqrt(n_eff) * d)


def kmer_significance(
    counts_path: str, pval_path: str, top_bot_path: str, pdf_path: str,
    title: str,
) -> None:
    """Significance test + volcano plot (kmer_analysis.R:16-52).

    Above the reference's data-size gate (sum(refCount) > 1000 and
    sum(readCount) > 10000, kmer_analysis.R:9) this runs the reference's
    own statistic: 1000 resampled trials of 5000 draws per distribution,
    per-kmer two-sample KS test, Bonferroni correction.  Below the gate
    the R script writes nothing; we instead fall back to a cheap
    two-proportion z-test so toy datasets still get the output files.
    Outputs keep the R script's file roles: a per-kmer p-value table, a
    top/bottom-20 significant table, and the volcano plot (adjusted p vs
    log fold change, as R plots it).
    """
    rows = []
    with open(counts_path) as fh:
        header = fh.readline()
        for line in fh:
            p = line.split()
            rows.append(
                (p[0], int(p[1]), float(p[2]), int(p[3]), float(p[4]), p[5])
            )
    if not rows:
        return
    ref_total = sum(r[1] for r in rows)
    read_total = sum(r[3] for r in rows)
    use_ks = ref_total > 1000 and read_total > 10000
    if use_ks:
        pvals = resampled_ks_pvalues(
            np.array([r[2] for r in rows]),
            np.array([r[4] for r in rows]),
        )
        results = [row + (float(pv),) for row, pv in zip(rows, pvals)]
    else:
        results = []
        for kmer, rc, rf, qc, qf, fold in rows:
            if ref_total == 0 or read_total == 0:
                pval = 1.0
            else:
                p_pool = (rc + qc) / (ref_total + read_total)
                se = math.sqrt(
                    max(p_pool * (1 - p_pool), 1e-300)
                    * (1.0 / ref_total + 1.0 / read_total)
                )
                z = (qf - rf) / se if se > 0 else 0.0
                pval = math.erfc(abs(z) / math.sqrt(2))
            results.append((kmer, rc, rf, qc, qf, fold, pval))
    n = len(results)
    with open(pval_path, "w") as fh:
        fh.write(
            "kmer\trefCount\trefFraction\treadCount\treadFraction\t"
            "logFoldChange\tpValue\tpValueBonferroni\n"
        )
        for kmer, rc, rf, qc, qf, fold, pval in results:
            fh.write(
                "%s\t%d\t%s\t%d\t%s\t%s\t%g\t%g\n"
                % (kmer, rc, rf, qc, qf, fold, pval, min(1.0, pval * n))
            )
    # Significant = Bonferroni-adjusted p <= 0.05, ordered by
    # logFoldChange (Inf/-Inf sort to the ends, as R's order() does);
    # top 20 + reversed bottom 20 (kmer_analysis.R:40-52).
    sig = [r for r in results if min(1.0, r[6] * n) <= 0.05]
    sig.sort(key=lambda r: float(r[5]))
    with open(top_bot_path, "w") as fh:
        fh.write(header.rstrip("\n") + "\tpValueBonferroni\n")
        for r in sig[:20] + sig[-20:][::-1]:
            fh.write(
                "%s\t%d\t%s\t%d\t%s\t%s\t%g\n"
                % (r[0], r[1], r[2], r[3], r[4], r[5], min(1.0, r[6] * n))
            )
    if HAVE_MPL:
        try:
            finite = [r for r in results if r[5] not in ("Inf", "-Inf")]
            folds = np.array([float(r[5]) for r in finite])
            adj = np.array([min(1.0, r[6] * n) for r in finite])
            # R plots adjusted p (linear) vs log fold change
            # (kmer_analysis.R:43-44).
            fig, ax = plt.subplots(figsize=(6, 5))
            ax.scatter(folds, adj, s=6, alpha=0.5)
            ax.set_xlabel("Log Fold Change")
            ax.set_ylabel("Adjusted P Value")
            ax.set_title("%s Volcano Plot" % title)
            fig.tight_layout()
            fig.savefig(pdf_path)
            plt.close(fig)
        except Exception as exc:  # pragma: no cover
            logger.warning("volcano plot failed: %s", exc)


@_safe
def channel_plots(
    tsv_path: str, pdf_path: str, sorted_png: str, level_png: str,
    level_pct_png: str,
) -> None:
    """Per-channel mappability plots (channel_plots.R)."""
    data = np.genfromtxt(tsv_path, names=True, delimiter="\t")
    channel = np.atleast_1d(data["Channel"])
    total = np.atleast_1d(data["ReadCount"])
    mapped = np.atleast_1d(data["MappableReadCount"])
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(channel, total, width=1.0, label="reads", color="#cccccc")
    ax.bar(channel, mapped, width=1.0, label="mapped", color="#3b6fb6")
    ax.set_xlabel("channel")
    ax.set_ylabel("reads")
    ax.legend()
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)

    order = np.argsort(-total)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(order)), total[order], width=1.0, color="#cccccc")
    ax.bar(range(len(order)), mapped[order], width=1.0, color="#3b6fb6")
    ax.set_xlabel("channel (sorted by reads)")
    fig.tight_layout()
    fig.savefig(sorted_png)
    plt.close(fig)

    side = 32  # 512 channels as 16x32 grid
    for path, values in (
        (level_png, mapped),
        (level_pct_png, np.where(total > 0, mapped / np.maximum(total, 1), 0)),
    ):
        grid = np.zeros(side * 16)
        idx = (channel - 1).astype(int)
        ok = (idx >= 0) & (idx < len(grid))
        grid[idx[ok]] = values[ok]
        fig, ax = plt.subplots(figsize=(8, 5))
        im = ax.imshow(grid.reshape(16, side), cmap="viridis")
        fig.colorbar(im)
        ax.set_title("channel mappability")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)


@_safe
def histogram_plot(values, pdf_path: str, xlabel: str) -> None:
    """Simple histogram (match_hist.R and friends)."""
    values = np.asarray([v for v in values if np.isfinite(v)])
    fig, ax = plt.subplots(figsize=(6, 4))
    if len(values):
        ax.hist(values, bins=min(40, max(3, len(values))), color="#3b6fb6")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("count")
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)


@_safe
def emissions_plot(tsv_path: str, pdf_path: str) -> None:
    """Insert/delete gap emission bars (emissions_plot.R)."""
    with open(tsv_path) as fh:
        bases = fh.readline().split()
        ins = [float(x) for x in fh.readline().split()]
        dels = [float(x) for x in fh.readline().split()]
    x = np.arange(len(bases))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(x - 0.2, ins, width=0.4, label="insert emissions")
    ax.bar(x + 0.2, dels, width=0.4, label="delete emissions")
    ax.set_xticks(x, bases)
    ax.legend()
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)


@_safe
def running_likelihood_plot(tsv_path: str, pdf_path: str) -> None:
    """EM convergence traces, one line per trial (running_likelihood.R)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    with open(tsv_path) as fh:
        for t, line in enumerate(fh):
            vals = [float(x) for x in line.split()]
            ax.plot(range(1, len(vals) + 1), vals, label="trial %d" % t)
    ax.set_xlabel("EM iteration")
    ax.set_ylabel("log likelihood")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)


def venn_counts(sets: dict[str, set], universe: set | None = None) -> list:
    """vennCounts semantics (vennDiagram.R:63-100, include="both").

    Returns ``[(membership_tuple, count), ...]`` over all 2^n outcome
    rows, ordered exactly as R's ``table(xlist)`` linearisation: the
    LAST set's bit varies fastest, so row index p has set j (1-based,
    first set = most significant bit) present iff bit (n-j) of p is 1.
    Row 0 counts universe elements in no set (the reference feeds the
    full per-read table, so unmapped reads land there).
    """
    names = list(sets)
    n = len(names)
    if universe is None:
        universe = set().union(*sets.values()) if sets else set()
    counts = [0] * (1 << n)
    for item in universe:
        p = 0
        for j, name in enumerate(names):  # j=0 is the MSB (column 1)
            if item in sets[name]:
                p |= 1 << (n - 1 - j)
        counts[p] += 1
    rows = []
    for p in range(1 << n):
        member = tuple((p >> (n - 1 - j)) & 1 for j in range(n))
        rows.append((member, counts[p]))
    return rows


# Region-label coordinates per set count, indexed by the vennCounts row
# order above — transcribed from vennDiagram.R's printing functions
# (vennDiagram.R:165-263).
_VENN_LAYOUT = {
    1: dict(
        centers=[(0, 0)],
        radii=(1.5, 1.5),
        rotate=[0],
        name_pos=[(-1.2, 1.8)],
        count_pos=[(2.3, -2.1), (0, 0)],
    ),
    2: dict(
        centers=[(-1, 0), (1, 0)],
        radii=(1.5, 1.5),
        rotate=[0, 0],
        name_pos=[(-1.2, 1.8), (1.2, 1.8)],
        count_pos=[(2.3, -2.1), (1.5, 0.1), (-1.5, 0.1), (0, 0.1)],
    ),
    3: dict(
        centers=[
            (-1, 1 / math.sqrt(3)),
            (1, 1 / math.sqrt(3)),
            (0, -2 / math.sqrt(3)),
        ],
        radii=(1.5, 1.5),
        rotate=[0, 0, 0],
        name_pos=[(-1.2, 2.4), (1.2, 2.4), (0, -3)],
        count_pos=[
            (2.5, -3), (0, -1.7), (1.5, 1), (0.75, -0.35),
            (-1.5, 1), (-0.75, -0.35), (0, 0.9), (0, 0),
        ],
    ),
    4: dict(
        centers=[(-0.2, 0.20), (0.2, 0.20), (-1.05, -0.35), (1.05, -0.35)],
        radii=(1.5, 2.7),
        rotate=[-45, 45, -45, 45],
        name_pos=[(-3.2, 3.2), (3.2, 3.2), (-3.2, -3.2), (3.2, -3.2)],
        count_pos=[
            (0, -3), (2.5, 0), (-2.5, 0), (0, -2.0),
            (1.3, 2.1), (1.7, 1.2), (-1.6, -1.1), (-0.8, -1.55),
            (-1.3, 2.1), (1.6, -1.1), (-1.7, 1.2), (0.8, -1.55),
            (0, 1.6), (0.9, 0.5), (-0.9, 0.5), (0, -0.5),
        ],
    ),
}

_VENN4_COLORS = ["red", "blue", "orange", "green"]


def _draw_venn_page(ax, names, rows, layout, n):
    from matplotlib.patches import Ellipse

    circle_col = _VENN4_COLORS if n == 4 else ["black"] * n
    ax.set_xlim(-4, 4)
    ax.set_ylim(-4, 4)
    ax.set_aspect("equal")
    ax.axis("off")
    for i in range(n):
        cx, cy = layout["centers"][i]
        r1, r2 = layout["radii"]
        # R's ellipse() rotates clockwise by `rotate` degrees
        # (vennDiagram.R:44-52); matplotlib's angle is CCW.
        ax.add_patch(Ellipse(
            (cx, cy), 2 * r1, 2 * r2, angle=-layout["rotate"][i],
            fill=False, edgecolor=circle_col[i], lw=2,
        ))
        tx, ty = layout["name_pos"][i]
        ax.text(tx, ty, names[i], color=circle_col[i], fontsize=12,
                ha="center", va="center")
    for (member, count), (tx, ty) in zip(rows, layout["count_pos"]):
        n_in = sum(member)
        # 4-set: single-set regions labelled in the set's colour, with
        # set-coloured underline ticks marking membership, per the R
        # printing function (vennDiagram.R:205-263).
        col = "black"
        if n == 4 and n_in == 1:
            col = circle_col[member.index(1)]
        ax.text(tx, ty, str(count), color=col, fontsize=11,
                ha="center", va="center")
        if n == 4 and n_in >= 1:
            for k, (j, _) in enumerate(
                (j, m) for j, m in enumerate(member) if m
            ):
                y = ty - 0.2 - 0.05 * k
                ax.plot([tx - 0.25, tx + 0.25], [y, y],
                        color=circle_col[j], lw=1)


@_safe
def venn_plot(
    sets: dict[str, set], pdf_path: str, universe: set | None = None
) -> None:
    """Venn diagram with vennCounts/vennDiagram semantics
    (vennDiagram.R:63-283).

    1-3 sets draw circles, 4 sets draw rotated ellipses with
    colour-coded membership ticks; page 2 repeats the diagram with
    region percentages (vennDiagram.R:279-283), matching the R output.
    >4 sets (the R code errors) falls back to an UpSet-style bar chart.
    """
    from matplotlib.backends.backend_pdf import PdfPages

    names = list(sets)
    n = len(names)
    if n == 0:
        return
    rows = venn_counts(sets, universe)
    if n > 4:
        _venn_fallback_bars(sets, pdf_path)
        return
    layout = _VENN_LAYOUT[n]
    total = sum(c for _, c in rows) or 1
    pct_rows = [(m, round(100.0 * c / total, 2)) for m, c in rows]
    with PdfPages(pdf_path) as pdf:
        for page_rows in (rows, pct_rows):
            fig, ax = plt.subplots(figsize=(7, 7))
            _draw_venn_page(ax, names, page_rows, layout, n)
            pdf.savefig(fig)
            plt.close(fig)


@_safe
def _venn_fallback_bars(sets: dict[str, set], pdf_path: str) -> None:
    from itertools import combinations

    names = list(sets)
    combos = []
    for r in range(1, len(names) + 1):
        for combo in combinations(names, r):
            inter = set.intersection(*(sets[c] for c in combo))
            outer = set.union(
                *(sets[c] for c in names if c not in combo), set()
            ) if len(combo) < len(names) else set()
            exclusive = inter - outer
            combos.append(("+".join(combo), len(exclusive)))
    fig, ax = plt.subplots(figsize=(max(6, len(combos)), 4))
    ax.bar(range(len(combos)), [c[1] for c in combos], color="#3b6fb6")
    ax.set_xticks(range(len(combos)), [c[0] for c in combos],
                  rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("reads mapped by exactly this set")
    fig.tight_layout()
    fig.savefig(pdf_path)
    plt.close(fig)
