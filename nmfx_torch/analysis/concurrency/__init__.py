"""Concurrency-discipline rules (NMFX012-015) for the threaded service
tier, built on one shared statically-derived model (``model.py``) and
cross-validated at runtime by the instrumented-lock witness
(``nmfx_torch/analysis/witness.py``); the counterparts of
``nmfx/analysis/concurrency/``, read against ``nmfx_torch/guards.py``."""

from nmfx_torch.analysis.concurrency.model import (ConcurrencyModel,
                                             concurrency_model)

# registering imports — each populates nmfx_torch.analysis.core.RULES
from nmfx_torch.analysis.concurrency import rules_guarded    # noqa: F401
from nmfx_torch.analysis.concurrency import rules_lockorder  # noqa: F401
from nmfx_torch.analysis.concurrency import rules_futures    # noqa: F401
from nmfx_torch.analysis.concurrency import rules_threads    # noqa: F401

__all__ = ["ConcurrencyModel", "concurrency_model"]
