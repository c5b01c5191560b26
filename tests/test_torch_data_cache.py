"""The device-resident input cache (``nmfx_torch/data_cache.py``), as
``tests/test_data_cache.py`` pins the reference's: a repeat placement
copies nothing (the module counters), the key is content and not
identity, it tells placements apart, the LRU and byte bounds hold, the
chunked copy is bit-equal, every key field is compared, byte views of
another dtype are never aliased, and a second ``nmfconsensus`` over the
same array copies zero bytes. On the CPU the "transfer" is the copy into
the placed tensor."""

import dataclasses

import numpy as np
import pytest
import torch

import nmfx_torch
from nmfx_torch import data_cache
from nmfx_torch.config import SolverConfig
from nmfx_torch.data_cache import DataCache, DataKey, data_key_fields

SCFG = SolverConfig()
CPU = torch.device("cpu")


def _matrix(seed=0, shape=(40, 12)):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size=shape)


def test_repeat_place_is_zero_transfer():
    cache = DataCache()
    a = _matrix(0)
    t0, b0 = data_cache.transfer_count(), data_cache.h2d_bytes()
    x1 = cache.place(a, SCFG, CPU)
    assert data_cache.transfer_count() == t0 + 1
    assert data_cache.h2d_bytes() == b0 + a.size * 4
    assert cache.place(a, SCFG, CPU) is x1
    assert data_cache.transfer_count() == t0 + 1
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 1
    assert x1.dtype == torch.float32
    np.testing.assert_array_equal(x1.numpy(), a.astype(np.float32))


def test_content_not_identity():
    cache = DataCache()
    a = _matrix(1)
    x1 = cache.place(a, SCFG, CPU)
    t = data_cache.transfer_count()
    assert cache.place(a.copy(), SCFG, CPU) is x1
    a[0, 0] += 1.0  # the caller changes it in place: a new copy
    x3 = cache.place(a, SCFG, CPU)
    assert x3 is not x1 and data_cache.transfer_count() == t + 1
    assert float(x3[0, 0]) == pytest.approx(float(a[0, 0]))


def test_key_discriminates_placement():
    cache = DataCache()
    a = _matrix(2)
    base = cache.key_for(a, "float32", CPU)
    assert cache.key_for(a, "float64", CPU) != base
    assert cache.key_for(a, "float32", CPU, pad_shape=(48, 16)) != base
    assert cache.key_for(a.astype(np.float32), "float32", CPU) != base
    assert cache.key_for(a[:, :6], "float32", CPU) != base
    x32 = cache.place(a, SCFG, CPU)
    x64 = cache.place(a, SolverConfig(algorithm="als", dtype="float64"),
                      CPU)
    assert x64.dtype == torch.float64 and x32.dtype == torch.float32
    xp = cache.place(a, SCFG, CPU, pad_shape=(48, 16))
    assert xp.shape == (48, 16) and float(xp[40:].abs().sum()) == 0.0


def test_device_tensor_passes_through_uncached():
    cache = DataCache()
    t = torch.rand(8, 5, dtype=torch.float32)
    n = data_cache.transfer_count()
    assert cache.place(t, SCFG, CPU) is t
    assert data_cache.transfer_count() == n and cache.stats["entries"] == 0


def test_lru_and_byte_bounds():
    cache = DataCache(max_entries=2)
    xs = [_matrix(s) for s in range(3)]
    for a in xs:
        cache.place(a, SCFG, CPU)
    assert cache.stats["entries"] == 2 and cache.stats["evictions"] == 1
    n = data_cache.transfer_count()
    cache.place(xs[0], SCFG, CPU)  # evicted: copied again
    assert data_cache.transfer_count() == n + 1
    small = DataCache(max_bytes=100)
    small.place(_matrix(5), SCFG, CPU)  # 1920 bytes: placed, not kept
    assert small.stats["entries"] == 0
    cache.resize(max_bytes=0)
    assert cache.stats["entries"] == 0
    with pytest.raises(ValueError):
        DataCache(max_entries=0)
    with pytest.raises(ValueError):
        cache.resize(max_bytes=-1)


def test_chunked_copy_bitwise_equal(monkeypatch):
    monkeypatch.setattr(data_cache, "_CHUNK_MIN_BYTES", 1024)
    monkeypatch.setattr(data_cache, "_CHUNK_BYTES", 512)
    host = np.arange(300 * 16, dtype=np.float32).reshape(300, 16)
    out = data_cache._chunked_copy(host, CPU)
    np.testing.assert_array_equal(out.numpy(), host)


def test_key_fields_cover_every_field():
    assert data_key_fields() == frozenset(
        f.name for f in dataclasses.fields(DataKey))
    assert {"fingerprint", "src_dtype", "shape", "dtype", "pad_shape",
            "device"} == data_key_fields()


def test_byte_view_aliasing_rejected():
    cache = DataCache()
    a = np.asarray([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
    b = a.view(np.int32).copy()  # the same bytes, other values
    x, y = cache.place(a, SCFG, CPU), cache.place(b, SCFG, CPU)
    assert y is not x
    np.testing.assert_array_equal(y.numpy(), b.astype(np.float32))


def test_second_nmfconsensus_copies_zero_bytes():
    a = _matrix(7, (50, 12))
    kw = dict(ks=(2, 3), restarts=2, max_iter=20, device="cpu")
    r1 = nmfx_torch.nmfconsensus(a, **kw)
    t, b = data_cache.transfer_count(), data_cache.h2d_bytes()
    r2 = nmfx_torch.nmfconsensus(a, **kw)
    assert (data_cache.transfer_count(), data_cache.h2d_bytes()) == (t, b)
    for k in (2, 3):
        assert np.array_equal(r1.per_k[k].consensus, r2.per_k[k].consensus)
