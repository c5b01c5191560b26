"""nmfx_torch — consensus NMF in PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (H100), ported from the JAX package ``nmfx``.

This package imports ``torch`` and numpy, never ``jax`` nor anything of
``nmfx``. Its entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU the kernels' plain PyTorch versions run.
"""

from nmfx_torch.agreement import (adjusted_rand_index, consensus_agreement,
                                  cophenetic_gap, membership_agreement)
from nmfx_torch.api import (ConsensusResult, InsufficientRestarts, KResult,
                            nmf, nmfconsensus, restart_factors, run_example,
                            save_results)
from nmfx_torch.config import (CheckpointConfig, ConsensusConfig,
                               ExecCacheConfig, ExperimentalConfig,
                               InitConfig, OutputConfig, ResultCacheConfig,
                               SolverConfig)
from nmfx_torch.exec_cache import ExecCache
from nmfx_torch.io import read_dataset, read_gct, read_res, write_gct
from nmfx_torch.solvers.base import SolverResult, StopReason
from nmfx_torch.sweep import (RestartResult, consensus_from_cells,
                              grid_cells, reduce_grid)

__all__ = ["ConsensusResult", "InsufficientRestarts", "KResult", "nmf",
           "nmfconsensus", "restart_factors", "run_example", "save_results",
           "RestartResult", "consensus_from_cells", "grid_cells",
           "reduce_grid",
           "CheckpointConfig", "ConsensusConfig", "ExecCache",
           "ExecCacheConfig", "ExperimentalConfig", "InitConfig",
           "OutputConfig", "ResultCacheConfig", "SolverConfig", "SolverResult",
           "StopReason",
           "adjusted_rand_index", "consensus_agreement", "cophenetic_gap",
           "membership_agreement",
           "read_dataset", "read_gct", "read_res", "write_gct",
           "kernels_available"]


def kernels_available() -> bool:
    """Whether the hand-written kernels can run here: a CUDA device is
    present (they are built with nvcc on first use)."""
    import torch

    return torch.cuda.is_available()
