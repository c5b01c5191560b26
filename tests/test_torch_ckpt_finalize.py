"""The checkpoint ledger's rank finalize (``checkpoint._finalize_rank``):
its connectivity counts are one float64 GEMM of the (n, R·k) one-hots,
exact because every product is 0 or 1 and every count at most R < 2^53.
Held here byte-equal to numpy's int64 einsum of the same one-hots (the
form it replaced, and the one ``nmfx/checkpoint.py`` keeps), divided by
the survivor count as before, with and without masked lanes."""

import numpy as np
import pytest

from nmfx_torch.checkpoint import _finalize_rank
from nmfx_torch.config import ConsensusConfig
from nmfx_torch.solvers.base import StopReason
from nmfx_torch.sweep import ChunkSweepOutput
from test_torch_solvers import _one_torch_thread  # noqa: F401 (autouse)


def _records(restarts, n, k, chunk, masked, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, (restarts, n)).astype(np.int32)
    stops = np.full(restarts, int(StopReason.CLASS_STABLE), np.int32)
    stops[list(masked)] = int(StopReason.NUMERIC_FAULT)
    labels[list(masked)] = -1
    dnorms = rng.uniform(0.1, 1.0, restarts).astype(np.float32)
    dn = np.where(np.isin(np.arange(restarts), masked), np.inf, dnorms)
    recs = {}
    for r0 in range(0, restarts, chunk):
        r1 = min(r0 + chunk, restarts)
        best = int(np.argmin(dn[r0:r1]))
        recs[(r0, r1)] = ChunkSweepOutput(
            labels[r0:r1], np.full(r1 - r0, 40, np.int32), dnorms[r0:r1],
            stops[r0:r1], np.int32(best), np.zeros((3, k), np.float32),
            np.zeros((k, n), np.float32))
    return recs, labels, stops


def _einsum_consensus(labels, stops, k, restarts):
    faulted = stops == int(StopReason.NUMERIC_FAULT)
    onehot = (labels[~faulted][:, :, None]
              == np.arange(k)[None, None, :]).astype(np.int64)
    counts = np.einsum("rik,rjk->ij", onehot, onehot)
    n_fault = int(faulted.sum())
    div = max(restarts - n_fault, 1) if n_fault else restarts
    return counts / np.float64(div)


@pytest.mark.parametrize("restarts,n,k,chunk,masked", [
    (50, 500, 10, 10, ()), (50, 500, 2, 7, (3, 17)), (10, 40, 4, 10, ()),
    (6, 24, 3, 2, (0, 1, 2, 3, 4, 5))])
def test_finalize_consensus_byte_equal_to_int64_einsum(restarts, n, k,
                                                       chunk, masked):
    recs, labels, stops = _records(restarts, n, k, chunk, masked, seed=n)
    out = _finalize_rank(k, recs, ConsensusConfig(ks=(k,),
                                                  restarts=restarts),
                         (3, n))
    want = _einsum_consensus(labels, stops, k, restarts)
    assert out.consensus.dtype == want.dtype == np.float64
    assert out.consensus.tobytes() == want.tobytes()
