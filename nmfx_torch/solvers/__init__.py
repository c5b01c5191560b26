"""Single-restart solvers (counterpart of ``nmfx/solvers``); the port
has mu and hals."""

from nmfx_torch.solvers import hals, mu

SOLVERS = {"mu": mu, "hals": hals}
