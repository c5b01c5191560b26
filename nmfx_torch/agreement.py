"""Consensus-level agreement between clustering results: a copy of
``nmfx/agreement.py`` (pure numpy).

What consensus NMF consumes from a solver is per-sample cluster
structure, so two pipelines are compared there: the memberships they
derive from their consensus matrices must agree (adjusted Rand index,
pairwise co-membership agreement) and their cophenetic correlations must
sit within a recorded gap. This is the measure of ``ROADMAP.md``'s
full-sweep parity tier, and the yardstick for engines that are not exact.

All label comparisons are PERMUTATION-INVARIANT: both ARI and pairwise
agreement read only the co-membership structure, never the label values.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

__all__ = ["adjusted_rand_index", "consensus_agreement",
           "cophenetic_gap", "membership_agreement"]


def _as_labels(x) -> np.ndarray:
    arr = np.asarray(x).ravel()
    if arr.size == 0:
        raise ValueError("labelings must be non-empty")
    return arr


def membership_agreement(a, b) -> float:
    """Pairwise co-membership agreement of two labelings of the same
    samples: the fraction of sample PAIRS (i < j) on which the two
    partitions agree — both place the pair together, or both apart.
    1.0 = identical partitions (up to relabeling); a single sample
    (no pairs) is vacuously 1.0. This is the unadjusted Rand index —
    kept alongside :func:`adjusted_rand_index` because its absolute
    scale ("x% of pairs agree") is the operator-readable number."""
    a = _as_labels(a)
    b = _as_labels(b)
    if a.shape != b.shape:
        raise ValueError(
            f"labelings must have equal length, got {a.size} vs {b.size}")
    if a.size < 2:
        return 1.0
    iu = np.triu_indices(a.size, k=1)
    co_a = (a[:, None] == a[None, :])[iu]
    co_b = (b[:, None] == b[None, :])[iu]
    return float(np.mean(co_a == co_b))


def adjusted_rand_index(a, b) -> float:
    """Adjusted Rand index (Hubert & Arabie 1985) of two labelings of
    the same samples: pair-counting agreement corrected for chance —
    1.0 = identical partitions (up to relabeling), ~0 = what random
    labelings score, negative = worse than chance.

    Degenerate partitions (both all-one-cluster, or both
    all-singletons) make the adjustment's denominator zero; they are
    defined here as 1.0 when the two partitions are identical as
    partitions (the scikit-learn convention) — the cases where "no
    structure" agrees with "no structure"."""
    a = _as_labels(a)
    b = _as_labels(b)
    if a.shape != b.shape:
        raise ValueError(
            f"labelings must have equal length, got {a.size} vs {b.size}")
    n = a.size
    if n < 2:
        return 1.0
    # contingency table over the label sets actually present
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    na, nb = ai.max() + 1, bi.max() + 1
    ct = np.zeros((na, nb), dtype=np.int64)
    np.add.at(ct, (ai, bi), 1)

    def comb2(x):
        x = np.asarray(x, dtype=np.float64)
        return x * (x - 1.0) / 2.0

    sum_idx = comb2(ct).sum()
    sum_a = comb2(ct.sum(axis=1)).sum()
    sum_b = comb2(ct.sum(axis=0)).sum()
    total = comb2(n)
    expected = sum_a * sum_b / total
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == expected:
        # degenerate: both partitions trivial (all-together or
        # all-apart). Identical structure -> perfect agreement.
        return 1.0 if membership_agreement(a, b) == 1.0 else 0.0
    return float((sum_idx - expected) / (max_idx - expected))


def cophenetic_gap(res_a, res_b,
                   ks: "Sequence[int] | None" = None) -> float:
    """Max |rho_a − rho_b| over the shared ranks of two
    :class:`~nmfx_torch.api.ConsensusResult`\\ s — the rank-selection half of
    the agreement contract (two engines that cluster alike must also
    RANK alike)."""
    shared = _shared_ks(res_a, res_b, ks)
    return max(abs(res_a.per_k[k].rho - res_b.per_k[k].rho)
               for k in shared)


def _shared_ks(res_a, res_b, ks):
    shared = tuple(k for k in res_a.ks if k in set(res_b.ks))
    if ks is not None:
        ks = tuple(ks)
        missing = [k for k in ks if k not in shared]
        if missing:
            raise ValueError(
                f"rank(s) {missing} not present in both results "
                f"(shared: {list(shared)})")
        shared = ks
    if not shared:
        raise ValueError("the two results share no ranks")
    return shared


def consensus_agreement(res_a, res_b,
                        ks: "Sequence[int] | None" = None
                        ) -> "Mapping[str, object]":
    """Full agreement report between two
    :class:`~nmfx_torch.api.ConsensusResult`\\ s (for example the port's and
    the reference's) over their shared ranks (or an explicit ``ks`` subset):

    ``per_k``
        ``{k: {"ari", "membership_agreement", "rho_gap"}}`` — ARI and
        pairwise agreement of the cutree memberships, and that rank's
        |Δrho|.
    ``min_ari`` / ``mean_ari`` / ``max_rho_gap``
        the scalars a gate pins.
    """
    shared = _shared_ks(res_a, res_b, ks)
    per_k = {}
    for k in shared:
        ma, mb = res_a.per_k[k].membership, res_b.per_k[k].membership
        per_k[k] = {
            "ari": adjusted_rand_index(ma, mb),
            "membership_agreement": membership_agreement(ma, mb),
            "rho_gap": abs(res_a.per_k[k].rho - res_b.per_k[k].rho),
        }
    aris = [v["ari"] for v in per_k.values()]
    return {
        "per_k": per_k,
        "min_ari": min(aris),
        "mean_ari": float(np.mean(aris)),
        "max_rho_gap": max(v["rho_gap"] for v in per_k.values()),
    }
