"""The port's host COO extraction without its native library.

`MMSAE_DISABLE_NATIVE=1` forces the numpy paths of `coo_extract_topk` and
`coo_partition_splits`, and a failed g++ build falls back to them, as the
JAX package's `native/coo.py` does.  The triples and partitions are equal
with the switch on and off, and to the JAX package's numpy path; the
writer's merged splits and `.featidx` sidecars are byte-equal.  Integers
and float32 copies: exact, no tolerance."""

import hashlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.cache import Cache as JaxCache
from multimodal_sae_tpu.features.cache import FeatureCache as JaxFeatureCache
from multimodal_sae_tpu.features.cache import topk_latents_step as jax_topk_latents_step
from multimodal_sae_tpu.native import coo as jax_coo
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.features.cache import Cache, FeatureCache
from multimodal_sae_tpu_torch.native import coo


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's numpy path, whatever its library."""
    monkeypatch.setattr(jax_coo, "_lib", None)
    monkeypatch.setattr(jax_coo, "_tried", True)


def _topk(seed=0, B=3, S=7, K=8, L=96):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(B, S, K)).astype(np.float32)
    vals[np.abs(vals) < 0.3] = 0.0
    idx = rng.integers(0, L, size=(B, S, K))
    return vals, idx


def _extract_all(module, vals, idx, filt):
    """Every form of the extraction: int64 and int32 ids, returned and
    written into caller buffers."""
    out = []
    for ids in (idx.astype(np.int64), idx.astype(np.int32)):
        out.append(module.coo_extract_topk(vals, ids, 1e-5, filt, row_offset=5))
        cap = vals.size
        loc, act = np.zeros((cap + 3, 3), np.int64), np.zeros(cap + 3, np.float32)
        n = module.coo_extract_topk(vals, ids, 1e-5, filt, row_offset=5, out=(loc, act))
        out.append((loc[:n].copy(), act[:n].copy()))
    return out


def _partition_all(module, loc, act, boundaries):
    scratch = (np.zeros((len(act), 3), np.int64), np.zeros(len(act), np.float32))
    return [
        [(l.copy(), a.copy()) for l, a in module.coo_partition_splits(loc, act, boundaries, scratch=s)]
        for s in (None, scratch)
    ]


def _assert_pairs_equal(a, b):
    assert len(a) == len(b)
    for (la, aa), (lb, ab) in zip(a, b):
        assert la.dtype == lb.dtype == np.int64 and aa.dtype == ab.dtype == np.float32
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(aa, ab)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filtered"])
def test_switch_forces_the_numpy_paths_with_equal_results(monkeypatch, jax_numpy_path, filtered):
    vals, idx = _topk()
    filt = np.array([90, 3, 41, 7, 64, 12]) if filtered else None
    boundaries = np.array([0, 24, 48, 60, 96], dtype=np.int64)
    monkeypatch.delenv("MMSAE_DISABLE_NATIVE", raising=False)
    assert coo._load() is not None
    native = _extract_all(coo, vals, idx, filt)
    native_parts = _partition_all(coo, *native[0], boundaries)
    monkeypatch.setenv("MMSAE_DISABLE_NATIVE", "1")
    assert coo._load() is None
    fallback = _extract_all(coo, vals, idx, filt)
    fallback_parts = _partition_all(coo, *native[0], boundaries)
    reference = _extract_all(jax_coo, vals, idx, filt)
    reference_parts = _partition_all(jax_coo, *reference[0], boundaries)
    assert len(native[0][1]) > 0
    _assert_pairs_equal(fallback, native)
    _assert_pairs_equal(fallback, reference)
    for got, ref, nat in zip(fallback_parts, reference_parts, native_parts):
        _assert_pairs_equal(got, ref)
        _assert_pairs_equal(got, nat)
    monkeypatch.setenv("MMSAE_DISABLE_NATIVE", "0")
    assert coo._load() is not None


def test_failed_build_falls_back_to_numpy(monkeypatch, tmp_path):
    """A host whose g++ fails gets the numpy paths, built once a process."""
    vals, idx = _topk(seed=1)
    want = coo.coo_extract_topk(vals, idx)
    calls = []

    def failing_build(path):
        calls.append(path)
        raise RuntimeError("building coo.cpp failed")

    monkeypatch.delenv("MMSAE_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(coo, "_lib", None)
    monkeypatch.setattr(coo, "_build_failed", False)
    monkeypatch.setattr(coo, "library_path", lambda src: tmp_path / "libcoo-missing.so")
    monkeypatch.setattr(coo, "_build", failing_build)
    got = coo.coo_extract_topk(vals, idx)
    _assert_pairs_equal([got], [want])
    parts = coo.coo_partition_splits(*got, np.array([0, 50, 96]))
    assert sum(len(a) for _, a in parts) == len(got[1])
    assert len(calls) == 1


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest() for f in sorted(os.listdir(d))}


def _jax_topk_batches(n_batches=3, B=2, S=5, k=8, width=64, d_in=16):
    """Index-ascending (vals, idx) batches from the JAX cache step; the
    negative encoder bias leaves some of each token's k at zero."""
    jsae = JaxSae(d_in, JaxSaeConfig(num_latents=width, k=k), key=jax.random.PRNGKey(2))
    jsae.params["b_enc"] = jnp.full((width,), -0.9, jnp.float32)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n_batches):
        x = jnp.asarray(rng.normal(size=(B, S, d_in)).astype(np.float32))
        vals, idx = jax_topk_latents_step(jsae.params, x, jsae.cfg)
        out.append((np.asarray(vals), np.asarray(idx)))
    return out


def _write(cls, cache_cls, wrap, batches, out, streaming, n_splits=4):
    fc = cls.__new__(cls)
    fc.cache = cache_cls(shard_size=10, batch_size=2)
    fc.width, fc.batch_size = 64, 2
    fc.activation_dtype = np.dtype(np.float32)
    fc._stream, fc._stream_marks, fc._row_cursor = None, {}, 0
    if streaming:
        fc.enable_streaming(out, n_splits)
    for b, (vals, idx) in enumerate(batches):
        fc._host_step({"m": wrap(vals, idx)}, b, len(vals))
    fc.cache.save()
    fc.save_splits(n_splits, out)
    fc.concate_safetensors(n_splits, out)
    return _digests(os.path.join(out, "m"))


@pytest.mark.parametrize("streaming", [True, False], ids=["streaming", "buffered"])
def test_writer_bytes_equal_with_the_switch_on(tmp_path, monkeypatch, jax_numpy_path, streaming):
    batches = _jax_topk_batches()
    port = lambda v, i: (torch.from_numpy(v.copy()), torch.from_numpy(i.copy()), None)  # noqa: E731
    monkeypatch.delenv("MMSAE_DISABLE_NATIVE", raising=False)
    native = _write(FeatureCache, Cache, port, batches, str(tmp_path / "native"), streaming)
    monkeypatch.setenv("MMSAE_DISABLE_NATIVE", "1")
    fallback = _write(FeatureCache, Cache, port, batches, str(tmp_path / "fallback"), streaming)
    reference = _write(JaxFeatureCache, JaxCache, lambda v, i: (v, i), batches, str(tmp_path / "jax"), streaming)
    assert len(fallback) == 8 and sum(f.endswith(".featidx") for f in fallback) == 4
    assert fallback == native == reference
