"""tensor_core_products: the bf16 product tiles' sums in plain PyTorch.

The card's bf16 numerators (csrc/block_gemm.cuh) are float32 sums of
wgmma steps: each K step of 16 aligns its exact products to the largest
exponent among them (a product's is the sum of its operands'), truncates
each to a multiple of 2^(emax - 25), adds them exactly and truncates the
sum to float32; one float32 add a step. The card tests hold the tiles to
this function bit for bit; these cases pin each of its rules on the CPU.
"""

import numpy as np
import pytest
import torch

from nmfx_torch.ops.fused_mu import round_bf16, tensor_core_products


def _dot(x, y, **kw):
    """One output: the dot product of the vectors x and y."""
    x = torch.tensor(x, dtype=torch.float32)[None, :]
    y = torch.tensor(y, dtype=torch.float32)[:, None]
    return tensor_core_products(x, y, **kw)[0, 0].item()


def test_exact_sums_are_kept():
    """Small integers: every step's sum is exact, so is the result."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 8, (5, 40)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 8, (40, 3)), dtype=torch.float32)
    assert torch.equal(tensor_core_products(x, y), x @ y)


def test_a_step_truncates_its_sum():
    """1 + 1.5 * 2^-24 is kept whole by the alignment (2^-25 steps) and
    truncated to 1.0 in float32, where rounding to nearest gives 1 +
    2^-23."""
    x, y = [1.0, 1.5 * 2.0 ** -12], [1.0, 2.0 ** -12]
    assert _dot(x, y) == 1.0
    assert np.float32(1.0) + np.float32(1.5 * 2.0 ** -24) == 1.0 + 2.0 ** -23


def test_alignment_takes_the_operands_exponents():
    """1.5 * 1.5 = 2.25 aligns at the operands' exponent sum 0, not at the
    product's own 1: eight terms of 2^-25 survive the alignment and add
    2^-22, one float32 ulp of 2.25."""
    x = [1.5] + [2.0 ** -12] * 8
    y = [1.5] + [2.0 ** -13] * 8
    assert _dot(x, y) == 2.25 + 2.0 ** -22


def test_steps_add_in_float32():
    """Each step is summed alone and added by float32 rounding to nearest:
    a first step of 1.0 and a second of 1.5 * 2^-24 give 1 + 2^-23, where
    one truncated sum of both would give 1.0."""
    x = [1.0] + [0.0] * 15 + [1.5 * 2.0 ** -12]
    y = [1.0] + [0.0] * 15 + [2.0 ** -12]
    assert _dot(x, y) == 1.0 + 2.0 ** -23
    assert _dot(x[:1] + x[16:], y[:1] + y[16:]) == 1.0


def test_split_partials_add_in_float32():
    """With a split of 32, the steps 1, 0 | c, c (c = 0.375 of a float32
    ulp of 1) sum to 1 + (c + c) = 1 + 2^-23, where the unsplit order ((1
    + 0) + c) + c stays at 1.0."""
    c = (1.5 * 2.0 ** -12, 2.0 ** -13)
    x = [1.0] + [0.0] * 31 + [c[0]] + [0.0] * 15 + [c[0]]
    y = [1.0] + [0.0] * 31 + [c[1]] + [0.0] * 15 + [c[1]]
    assert _dot(x, y) == 1.0
    assert _dot(x, y, split=32) == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("shape,split", [((37, 123, 19), None),
                                         ((9, 600, 11), 256)])
def test_random_sums_sit_close_to_exact(shape, split):
    """Nonnegative bf16 operands: every output within 2^-20 of the exact
    sum; the rows' chunking changes no bit."""
    m, kdim, n = shape
    rng = np.random.default_rng(1)
    x = round_bf16(torch.as_tensor(rng.uniform(0, 1, (m, kdim)),
                                   dtype=torch.float32))
    y = round_bf16(torch.as_tensor(rng.uniform(0, 1, (kdim, n)),
                                   dtype=torch.float32))
    got = tensor_core_products(x, y, split)
    exact = x.double() @ y.double()
    assert ((got.double() - exact).abs() <= 2.0 ** -20 * exact).all()
    assert torch.equal(got, tensor_core_products(x, y, split, rows=4))
