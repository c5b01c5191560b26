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
The key chain (``key``, ``fold_in``, ``split``) runs on the host. The
initial factors are drawn there and move to the device once per rank.
Large draws (the sketched engine's projections) run on the device
instead: :func:`random_bits_device`, :func:`uniform_device` and
:func:`normal_device` hash the same counters with threefry written in
int64 tensor arithmetic masked to 32 bits, so their words equal the
host's bit for bit.

``normal`` is ``jax.random.normal``: ``sqrt(2)·erfinv(u)`` of a uniform
``u`` on ``[nextafter(-1, 0), 1)``, with XLA's erfinv polynomials
(:func:`erfinv`: Giles' single-precision form for float32, XLA's
three-branch form for float64), evaluated in torch operations on the
host and on the card alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


# --- the normal draw ----------------------------------------------------

#: XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
#: coefficients of the branch w < 5 and of the branch w >= 5, highest
#: power first
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
#: XLA's ErfInv64: the branches w < 6.25 (23 coefficients), w < 16 (19)
#: and w >= 16 (17), highest power first
_ERFINV64_LT625 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027)
_ERFINV64_LT16 = (
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208)
_ERFINV64_GE16 = (
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV32_LT5[0], _ERFINV32_GE5[0]).to(x.dtype)
    for c_lt, c_ge in zip(_ERFINV32_LT5[1:], _ERFINV32_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge).to(x.dtype) + p * w
    return p * x


def _erfinv64(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * -x)
    lt625, lt16 = w < 6.25, w < 16.0
    w = torch.where(lt625, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coefficient(i):
        c = torch.full_like(x, _ERFINV64_LT625[i])
        if i < 19:
            c = torch.where(lt625, c, _ERFINV64_LT16[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV64_GE16[i])
        return c

    p = coefficient(0)
    for i in range(1, 17):
        p = coefficient(i) + p * w
    for i in range(17, 19):
        p = torch.where(lt16, coefficient(i) + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt625, coefficient(i) + p * w, p)
    return p * x


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``ErfInv`` (the ``lax.erf_inv`` JAX's normal draw runs) on
    a float32 or float64 tensor: ``w = -log1p(-x²)``, a polynomial in a
    shifted ``w`` (or ``√w``) per branch, times x; ±1 map to ±inf.
    ``torch.erfinv`` is another approximation, which parts from JAX's
    draws in the last bits."""
    if x.dtype == torch.float32:
        y = _erfinv32(x)
    elif x.dtype == torch.float64:
        y = _erfinv64(x)
    else:
        raise ValueError(f"erfinv takes float32 or float64, got {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, y)


def _normal_bounds(dtype) -> tuple[float, float]:
    """The uniform's range of ``jax.random.normal``: [nextafter(-1, 0),
    1) in ``dtype``."""
    dtype = np.dtype(dtype)
    return float(np.nextafter(dtype.type(-1.0), dtype.type(0.0))), 1.0


def _sqrt2(dtype: torch.dtype) -> float:
    """sqrt(2) rounded to ``dtype``, as JAX's ``np.array(np.sqrt(2),
    dtype)``."""
    return float(np.asarray(np.sqrt(2.0), _NP_OF[dtype]))


_NP_OF = {torch.float32: np.float32, torch.float64: np.float64}
_TORCH_OF = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}


def normal(k: np.ndarray, shape: tuple[int, ...],
           dtype=np.float32) -> np.ndarray:
    """``jax.random.normal`` in float32 or float64 on the host: the
    numpy uniform of :func:`uniform`, then :func:`erfinv` (torch on the
    CPU). Equal to :func:`normal_device` on the CPU bit for bit."""
    dtype = np.dtype(dtype)
    if dtype not in _TORCH_OF:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    lo, hi = _normal_bounds(dtype)
    u = torch.from_numpy(np.ascontiguousarray(
        uniform(k, shape, lo, hi, dtype)))
    t_dt = _TORCH_OF[dtype]
    return (_sqrt2(t_dt) * erfinv(u)).numpy()


# --- the device draw ----------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32_device(k0: torch.Tensor, k1: torch.Tensor,
                        x0: torch.Tensor, x1: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors that hold uint32 words
    (each sum masked to 32 bits; a rotation's shifted word stays below
    2^61). ``k0``/``k1`` broadcast against the counters, so one call
    hashes a batch of keys."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl_t(x1, rot) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def _device_words(keys: np.ndarray, size: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both hashed words of counters ``0..size-1`` under every key of
    ``keys`` ((2,) or (B, 2)): int64 tensors of shape (size,) or
    (B, size) on ``device``."""
    keys = np.asarray(keys, np.uint32)
    kt = torch.as_tensor(keys.reshape(-1, 2).astype(np.int64),
                         device=device)
    k0, k1 = kt[:, :1], kt[:, 1:]
    idx = torch.arange(size, dtype=torch.int64, device=device)[None, :]
    y0, y1 = threefry2x32_device(k0, k1, idx >> 32, idx & _MASK32)
    if keys.ndim == 1:
        y0, y1 = y0[0], y1[0]
    return y0, y1


def random_bits_device(keys: np.ndarray, shape: tuple[int, ...], device,
                       bit_width: int = 32) -> torch.Tensor:
    """:func:`random_bits` on ``device`` for one key (2,) or a stack
    (B, 2) (then shape (B,) + ``shape``), as int64 tensors: 32-bit
    words ``y0 ^ y1``, or the top 52 bits of the 64-bit word ``y0 << 32
    | y1`` shifted right by 12 (the only part a float64 uniform reads;
    the full word does not fit a signed int64)."""
    size = int(np.prod(shape, dtype=np.int64))
    y0, y1 = _device_words(keys, size, device)
    if bit_width == 32:
        bits = y0 ^ y1
    elif bit_width == 52:
        bits = (y0 << 20) | (y1 >> 12)
    else:
        raise ValueError(f"bit_width must be 32 or 52, got {bit_width}")
    return bits.reshape(tuple(bits.shape[:-1]) + tuple(shape))


def uniform_device(keys: np.ndarray, shape: tuple[int, ...], minval: float,
                   maxval: float, dtype: torch.dtype, device
                   ) -> torch.Tensor:
    """:func:`uniform` on ``device``, for one key or a stack of keys,
    bit-equal to the host's: the mantissa fill of the same words, then
    ``max(lo, f·(hi − lo) + lo)`` in ``dtype`` (two rounded operations,
    as the host's)."""
    np_dt = np.dtype(_NP_OF[dtype])
    if dtype == torch.float32:
        bits = random_bits_device(keys, shape, device, 32)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
    elif dtype == torch.float64:
        bits = random_bits_device(keys, shape, device, 52)
        floats = (bits | 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    lo, hi = np_dt.type(minval), np_dt.type(maxval)
    span = float(hi - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def normal_device(keys: np.ndarray, shape: tuple[int, ...],
                  dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`normal` drawn on ``device`` (one key, or a stack (B, 2)
    giving (B,) + ``shape``): the words come from the device threefry,
    bit-equal to the host's; only the key chain stays on the host."""
    lo, hi = _normal_bounds(_NP_OF[dtype])
    u = uniform_device(keys, shape, lo, hi, dtype, device)
    return _sqrt2(dtype) * erfinv(u)
