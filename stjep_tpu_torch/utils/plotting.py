"""Attention/alignment heatmap plotting (a copy of stjep_tpu/utils/plotting.py;
ref: utils/misc.py:420-493). matplotlib is imported inside the functions:
the card host has none."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def plot_alignment(alignment, path: str, src: List[str], hyp: List[str],
                   ref: Optional[List[str]] = None):
    """Attention alignment heatmap PNG (ref: utils/misc.py:420-450)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 10))
    im = ax.imshow(np.asarray(alignment), aspect="auto", cmap="hot",
                   origin="lower", interpolation="none", vmin=0, vmax=1)
    fig.colorbar(im, ax=ax)
    plt.xticks(np.arange(len(src)), src, rotation=40)
    plt.yticks(np.arange(len(hyp)), hyp, rotation=20)
    xlabel = "Src"
    if ref is not None:
        xlabel += "\n\nRef: " + " ".join(ref)
    plt.xlabel(xlabel)
    plt.ylabel("Hyp")
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close(fig)


def plot_attention(alignment, path: str, words: List[str],
                   words_right: Optional[List[str]] = None):
    """Attention heatmap with word ticks (ref: utils/misc.py:453-493)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({"axes.xmargin": 0, "axes.ymargin": 0,
                         "figure.figsize": (12, 10)})
    fig, ax = plt.subplots(figsize=(12, 10))
    im = ax.imshow(np.asarray(alignment), aspect="auto", cmap="hot",
                   origin="lower", interpolation="none", vmin=0, vmax=1)
    fig.colorbar(im, ax=ax)
    ax.set_yticks(np.linspace(0, np.nanmax(ax.get_ybound()), len(words)))
    plt.yticks(np.arange(len(words)), words, rotation=20)
    if words_right is not None:
        ax_r = ax.twinx()
        ax_r.set_yticks(np.linspace(0, np.nanmax(ax_r.get_ybound()),
                                    len(words_right)))
        plt.yticks(np.arange(len(words_right)), words_right, rotation=20)
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close(fig)
