"""The eight update rules (counterpart of ``nmfx/solvers``): the
reference C library's mu, als, neals, pg and alspg, the BROAD original's
Brunet rule (kl), Kim & Park sparse NMF (snmf) and Cichocki & Phan HALS
(hals), each a lane-polymorphic ``step`` driven by
``base.run_loop_batched``."""

from nmfx_torch.solvers import als, alspg, hals, kl, mu, neals, pg, snmf

SOLVERS = {"mu": mu, "als": als, "neals": neals, "pg": pg, "alspg": alspg,
           "kl": kl, "snmf": snmf, "hals": hals}
