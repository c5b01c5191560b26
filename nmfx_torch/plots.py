"""Plot outputs: consensus heatmaps, all-k grid, cophenetic curve.

The port's copy of ``nmfx/plots.py`` (numpy and matplotlib only), writing
the same files under the same names. Covers the reference's plotting side
layer (``matrix.abs.plot``, ``ConsPlot``, ``metagene.plot``, cophenetic
curve; reference ``nmf.r:271-349`` and ``nmf.r:191-249``) with matplotlib
instead of base-R graphics. ``save_results`` imports this module only
when ``OutputConfig.write_plots`` is set, and skips the plots where
matplotlib is missing, so headless or matplotlib-free environments still
get all numerical outputs.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

#: no creation date in the files, so the same result writes the same bytes
#: (the command line's outputs are held byte-equal to the library's)
_METADATA = {"CreationDate": None}


def consensus_heatmap(mat: np.ndarray, path: str, title: str = "",
                      membership: np.ndarray | None = None) -> None:
    """Ordered consensus-matrix heatmap with optional class-boundary tags
    (reference ConsPlot's tag strip, nmf.r:314-336)."""
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(mat, cmap="viridis", vmin=0.0, vmax=1.0,
                   interpolation="nearest")
    if membership is not None:
        bounds = np.flatnonzero(np.diff(membership)) + 0.5
        for b in bounds:
            ax.axhline(b, color="white", lw=0.8)
            ax.axvline(b, color="white", lw=0.8)
    ax.set_title(title)
    ax.set_xlabel("samples")
    ax.set_ylabel("samples")
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(path, bbox_inches="tight", metadata=_METADATA)
    plt.close(fig)


def metagene_plot(h: np.ndarray, path: str, title: str = "") -> None:
    """Per-metagene amplitude lines (reference metagene.plot, nmf.r:294-304)."""
    fig, ax = plt.subplots(figsize=(8, 4))
    for i, row in enumerate(np.asarray(h)):
        ax.plot(row, lw=2, label=f"metagene {i + 1}")
    ax.set_xlabel("samples")
    ax.set_ylabel("amplitude")
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.savefig(path, bbox_inches="tight", metadata=_METADATA)
    plt.close(fig)


def matrix_plot(mat: np.ndarray, path: str, title: str = "") -> None:
    """Generic matrix-magnitude heatmap (reference ``matrix.abs.plot``'s
    value-inverted rainbow, nmf.r:271-292 — here |values| on a perceptually
    uniform map)."""
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(np.abs(np.asarray(mat)), cmap="viridis", aspect="auto",
                   interpolation="nearest")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.savefig(path, bbox_inches="tight", metadata=_METADATA)
    plt.close(fig)


def pca_plot(a: np.ndarray, path: str,
             labels: np.ndarray | None = None, title: str = "") -> None:
    """Samples scattered on the first two principal components, optionally
    colored by cluster label (reference ``plotPCA``, test_nmf.r:9-23 —
    defined for eyeballing group structure, never wired into the flow)."""
    a = np.asarray(a, np.float64)
    centered = a - a.mean(axis=1, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    pcs = vt[:2].T  # (n_samples, 2)
    fig, ax = plt.subplots(figsize=(6, 5))
    if labels is None:
        ax.scatter(pcs[:, 0], pcs[:, 1], s=30)
    else:
        sc = ax.scatter(pcs[:, 0], pcs[:, 1], c=np.asarray(labels),
                        cmap="tab10", s=30)
        fig.colorbar(sc, ax=ax, shrink=0.8, label="cluster")
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_title(title)
    fig.savefig(path, bbox_inches="tight", metadata=_METADATA)
    plt.close(fig)


def cophenetic_curve(ks, rhos, path: str) -> None:
    """rho-vs-k selection curve (reference nmf.r:227-231; same y-range rule
    ``[1 - 2*(1 - min(rho)), 1]``)."""
    ks = np.asarray(ks)
    rhos = np.asarray(rhos)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(ks, rhos, "-s", color="black", markersize=7)
    lo = 1 - 2 * (1 - rhos.min())
    ax.set_ylim(min(lo, rhos.min() - 0.01), 1.0)
    ax.set_xlabel("k")
    ax.set_ylabel("Cophenetic correlation")
    ax.set_title("Cophenetic Coefficient")
    fig.savefig(path, bbox_inches="tight", metadata=_METADATA)
    plt.close(fig)


def all_k_grid(result, path: str) -> None:
    """Grid of ordered consensus matrices over all k (reference 4×4 summary
    page, nmf.r:217-232)."""
    ks = result.ks
    cols = min(4, len(ks))
    rows = -(-len(ks) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    for ax in axes.flat:
        ax.axis("off")
    for ax, k in zip(axes.flat, ks):
        r = result.per_k[k]
        ax.axis("on")
        ax.imshow(r.ordered_consensus, cmap="viridis", vmin=0, vmax=1,
                  interpolation="nearest")
        ax.set_title(f"k={k}  rho={r.rho:.4f}", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.savefig(path, bbox_inches="tight", metadata=_METADATA)
    plt.close(fig)


def save_all(result, prefix: str) -> list[str]:
    """Write the full plot set for a ConsensusResult."""
    written = []
    for k in result.ks:
        r = result.per_k[k]
        path = f"{prefix}consensus.plot.k{k}.pdf"
        consensus_heatmap(r.ordered_consensus, path,
                          title=f"Consensus matrix k={k}",
                          membership=r.membership[r.order])
        written.append(path)
        # metagene amplitudes of the best restart, samples in dendrogram
        # order (the reference sketches this at nmf.r:200-204, commented out)
        path = f"{prefix}metagenes.k{k}.pdf"
        metagene_plot(r.best_h[:, r.order], path,
                      title=f"Metagenes (best restart), k={k}")
        written.append(path)
    path = f"{prefix}consensus.all.k.plot.pdf"
    all_k_grid(result, path)
    written.append(path)
    path = f"{prefix}cophenetic.plot.pdf"
    cophenetic_curve(result.ks, result.rhos, path)
    written.append(path)
    return written
