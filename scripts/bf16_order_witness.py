#!/usr/bin/env python3
"""How far the bf16 scheduler job of the card tests moves with the order
of its sums, on the CPU.

tests/test_torch_cuda.py::test_sched_options_on_card_match_cpu[bf16]
runs six jobs (k = 3, 3, 3, 2, 2, 2) of bf16-operand MU on a 200 x 24
two-group design for 200 iterations through the slot scheduler. This
runs the same jobs three times, changing only how the two numerator
products are summed: in float32 in order (the plain versions' matmul),
exactly (float64, rounded once to float32), and as the card's tensor
cores sum them (tensor_core_products). For each pair of runs it prints
how many of the 144 H labels differ and whether the iterations and stop
reasons agree.

    python3 scripts/bf16_order_witness.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import numpy as np
    import torch

    from nmfx_torch.config import SolverConfig
    from nmfx_torch.datasets import two_group_matrix
    from nmfx_torch.ops import fused_mu
    from nmfx_torch.ops.sched_mu import mu_sched

    rng = np.random.default_rng(4)
    a = two_group_matrix(n_genes=200, n_per_group=12, seed=3)
    ks = (3, 3, 3, 2, 2, 2)
    w0 = rng.uniform(0.0, 1.0, (len(ks), 200, 3)).astype(np.float32)
    h0 = rng.uniform(0.0, 1.0, (len(ks), 3, 24)).astype(np.float32)
    for j, k in enumerate(ks):
        w0[j, :, k:] = 0.0
        h0[j, k:] = 0.0
    cfg = SolverConfig(backend="pallas", max_iter=200,
                       matmul_precision="bfloat16")
    orders = {
        "in order": fused_mu._numer_product,
        "exact": lambda x, y, split=None: (x.double() @ y.double()).float(),
        "tensor cores": lambda x, y, split=None:
            fused_mu.tensor_core_products(x, y, split)}
    runs = {}
    for name, product in orders.items():
        fused_mu._numer_product = product
        runs[name] = mu_sched(a, w0, h0, cfg, slots=4, job_ks=ks,
                              device="cpu")
    names = list(runs)
    for i, x in enumerate(names):
        for y in names[i + 1:]:
            rx, ry = runs[x], runs[y]
            flips = int((rx.h.argmax(dim=1) != ry.h.argmax(dim=1)).sum())
            print(f"{x} vs {y}: {flips} of {rx.h.argmax(dim=1).numel()} H "
                  f"labels differ, iterations equal "
                  f"{torch.equal(rx.iterations, ry.iterations)}, stops equal "
                  f"{torch.equal(rx.stop_reason, ry.stop_reason)}, max |dH| "
                  f"{(rx.h - ry.h).abs().max().item():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
