"""Plotting layer: matplotlib replacements for the reference's R scripts.

The part of the JAX package's ``analyses/plots.py`` that the ported
analyses use: ``_safe`` and ``histogram_plot``.  The other plots come
with the analyses that draw them (ROADMAP A7).

All plotting is defensive: a plotting failure must never fail an
analysis (the data files are the contract; plots are a convenience),
and without matplotlib nothing is drawn.
"""

from __future__ import annotations

import logging

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
