"""JAX's partitionable threefry2x32 PRNG in numpy uint32 arithmetic.

The reference package draws every initial factor from the key chain
``split(fold_in(key(seed), k), R)[r]`` followed by ``random_init``'s
``split`` and two ``uniform`` draws. Reproducing that chain bit for bit
lets the port start each restart from exactly the factors the reference
starts from, so the two packages can be compared restart by restart.

Only the partitionable mode is implemented (the only mode of current
JAX, and the one the reference forces on older versions): ``split`` and
the random bits hash a 64-bit counter ``(hi, lo)`` with the key, and the
bits of a draw are ``y0 ^ y1`` of the two hashed words.

A key is a ``(2,)`` uint32 array, or ``(..., 2)`` for a stack of keys.
Everything runs on the host; the draws move to the device once per rank.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds: hash the counter words ``(x0, x1)``
    under ``key`` (2,) uint32. Matches ``jax._src.prng``'s lowering."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for rot in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, rot)
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data for a 32-bit integer seed:
    ``(seed >> 32, seed & 0xFFFFFFFF)``, i.e. ``(0, seed)``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the seed-key of ``data`` under ``k``."""
    y0, y1 = threefry2x32(k, np.uint32(0), np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([y0, y1], np.uint32)


def _counters(size: int) -> tuple[np.ndarray, np.ndarray]:
    """The flat 64-bit iota as (hi, lo) uint32 words."""
    idx = np.arange(size, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable): key ``i`` hashes counter
    ``i`` under ``k``. Returns ``(num, 2)`` uint32; prefix-stable in
    ``num``."""
    hi, lo = _counters(num)
    y0, y1 = threefry2x32(k, hi, lo)
    return np.stack([y0, y1], axis=1)


def random_bits(k: np.ndarray, shape: tuple[int, ...],
                bit_width: int = 32) -> np.ndarray:
    """Random words of ``shape`` (row-major counters): 32-bit words are
    ``y0 ^ y1`` of the two hashed words, 64-bit ones ``y0 << 32 | y1``
    (JAX's partitionable ``random_bits``)."""
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    y0, y1 = threefry2x32(k, hi, lo)
    if bit_width == 64:
        bits = (y0.astype(np.uint64) << np.uint64(32)) | y1.astype(np.uint64)
    elif bit_width == 32:
        bits = y0 ^ y1
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return bits.reshape(shape)


def uniform(k: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform`` in float32 or float64: the top 23 (52) bits
    of a 32-bit (64-bit) word fill a mantissa of [1, 2), shifted to
    [0, 1), then scaled in ``dtype`` arithmetic."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        bits = random_bits(k, shape, 64)
        floats = ((bits >> np.uint64(12))
                  | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
    elif dtype == np.float32:
        bits = random_bits(k, shape)
        floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32) - np.float32(1.0)
    else:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)
