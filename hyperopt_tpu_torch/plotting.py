"""matplotlib diagnostics over a Trials history (the port's copy of
:mod:`hyperopt_tpu.plotting`): loss-vs-time scatter
(``main_plot_history``), loss histogram (``main_plot_histogram``), and
per-hyperparameter scatters colored by loss (``main_plot_vars``).
matplotlib is imported when a plot is drawn, never at import: it is the
optional ``plotting`` extra.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import JOB_STATE_DONE, STATUS_OK

logger = logging.getLogger(__name__)

__all__ = ["main_plot_history", "main_plot_histogram", "main_plot_vars"]

default_status_colors = {
    "new": "k",
    "running": "g",
    "ok": "b",
    "fail": "r",
}


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _ok_losses(trials, bandit=None):
    losses, statuses = [], []
    for t in trials.trials:
        r = t["result"]
        statuses.append(r.get("status", "new"))
        losses.append(r.get("loss"))
    return losses, statuses


def main_plot_history(trials, do_show=True, status_colors=None, title=None):
    """Scatter of loss against trial order, colored by status; the running
    best is overlaid."""
    plt = _plt()
    if status_colors is None:
        status_colors = default_status_colors
    losses, statuses = _ok_losses(trials)

    for status in sorted(set(statuses)):
        xs = [i for i, s in enumerate(statuses) if s == status and losses[i] is not None]
        ys = [losses[i] for i in xs]
        plt.scatter(
            xs, ys, c=status_colors.get(status, "m"), label=status, s=12
        )
    ok = [
        (i, l)
        for i, (l, s) in enumerate(zip(losses, statuses))
        if s == STATUS_OK and l is not None and np.isfinite(l)
    ]
    if ok:
        best = np.minimum.accumulate([l for _, l in ok])
        plt.plot([i for i, _ in ok], best, "k--", lw=1, label="best so far")
    plt.xlabel("trial")
    plt.ylabel("loss")
    plt.title(title or "loss history")
    plt.legend(loc="best", fontsize=8)
    if do_show:
        plt.show()
    return plt.gcf()


def main_plot_histogram(trials, do_show=True, title=None):
    """Histogram of completed ok losses."""
    plt = _plt()
    losses = [
        t["result"]["loss"]
        for t in trials.trials
        if t["state"] == JOB_STATE_DONE
        and t["result"].get("status") == STATUS_OK
        and t["result"].get("loss") is not None
    ]
    if not losses:
        logger.warning("main_plot_histogram: no completed ok trials")
        return None
    plt.hist(np.asarray(losses, dtype=float), bins=min(30, max(5, len(losses) // 3)))
    plt.xlabel("loss")
    plt.ylabel("count")
    plt.title(title or f"loss histogram ({len(losses)} trials)")
    if do_show:
        plt.show()
    return plt.gcf()


def main_plot_vars(trials, do_show=True, colorize_best=10, columns=3):
    """Per-hyperparameter scatter of value vs loss; the best trials are
    highlighted."""
    plt = _plt()
    samples = []  # (label, value, loss)
    for t in trials.trials:
        if t["state"] != JOB_STATE_DONE:
            continue
        loss = t["result"].get("loss")
        if loss is None or not np.isfinite(float(loss)):
            continue
        for label, vals in t["misc"]["vals"].items():
            if len(vals) == 1:
                samples.append((label, vals[0], float(loss)))
    if not samples:
        logger.warning("main_plot_vars: nothing to plot")
        return None
    labels = sorted({s[0] for s in samples})
    all_losses = sorted(s[2] for s in samples)
    best_cut = (
        all_losses[min(colorize_best, len(all_losses) - 1)]
        if colorize_best
        else None
    )
    rows = int(np.ceil(len(labels) / columns))
    fig, axes = plt.subplots(
        rows, columns, figsize=(4 * columns, 3 * rows), squeeze=False
    )
    for i, label in enumerate(labels):
        ax = axes[i // columns][i % columns]
        pts = [(v, l) for (lab, v, l) in samples if lab == label]
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        colors = (
            ["r" if l <= best_cut else "b" for _, l in pts]
            if best_cut is not None
            else "b"
        )
        ax.scatter(xs, ys, c=colors, s=10)
        ax.set_title(label, fontsize=9)
        ax.set_ylabel("loss", fontsize=8)
    for j in range(len(labels), rows * columns):
        axes[j // columns][j % columns].axis("off")
    fig.tight_layout()
    if do_show:
        plt.show()
    return fig
