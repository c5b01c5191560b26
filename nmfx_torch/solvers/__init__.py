"""Single-restart solvers (counterpart of ``nmfx/solvers``); the port
has mu."""

from nmfx_torch.solvers import mu

SOLVERS = {"mu": mu}
