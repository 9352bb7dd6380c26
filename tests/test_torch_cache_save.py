"""The rest of the port's cache writer against the JAX package's:
`Cache.add`/`get_nonzeros` (the reference's dense path), and
`FeatureCache.save` (the unsplit `{module}.safetensors` layout) and
`save_splits` with `replicate_boundary_drop` off and on, byte for byte;
`filter_submodules`; `process_batch` against the run loop."""

import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.cache import Cache as JaxCache
from multimodal_sae_tpu.features.cache import FeatureCache as JaxFeatureCache
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.features.cache import Cache, FeatureCache
from multimodal_sae_tpu_torch.sae import Sae

WIDTH, N_SPLITS = 64, 4
BOUNDARY = (15, 31, 47, 63)  # the inclusive split ends the reference dropped


def _latents(seed, B=2, S=5):
    """Dense (B, S, WIDTH) masked latents with entries on every split
    boundary and some under the 1e-5 threshold."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, S, WIDTH)).astype(np.float32) * (rng.random((B, S, WIDTH)) > 0.7)
    x[:, :, BOUNDARY] = rng.random((B, S, len(BOUNDARY))) + 0.5
    x[0, 0, :3] = 1e-6
    return x


def _digests(d):
    return {
        os.path.relpath(os.path.join(p, f), d): hashlib.sha256(open(os.path.join(p, f), "rb").read()).hexdigest()
        for p, _, files in os.walk(d) for f in sorted(files)
    }


def _caches(filters=None):
    jsae = JaxSae(8, JaxSaeConfig(num_latents=WIDTH, k=4), key=jax.random.PRNGKey(0))
    sae = Sae(8, SaeConfig(num_latents=WIDTH, k=4), device="cpu")
    hooks = ("layers.0", "layers.1")
    return (FeatureCache(None, {h: sae for h in hooks}, batch_size=2, shard_size=6, filters=filters),
            JaxFeatureCache(None, {h: jsae for h in hooks}, batch_size=2, shard_size=6, filters=filters))


@pytest.mark.parametrize("kind", ["numpy", "torch", "torch bf16"])
@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
def test_cache_add_matches_jax(kind, filtered):
    filters = {"m": np.array([0, 15, 20, 31, 63])} if filtered else None
    ours, theirs = Cache(6, filters, batch_size=2), JaxCache(6, filters, batch_size=2)
    for b in range(3):
        x = _latents(b)
        if kind == "torch bf16":
            x = torch.from_numpy(x).bfloat16().float().numpy()  # bf16 values, widened exactly
            ours.add(torch.from_numpy(x).bfloat16(), b, "m")
        else:
            ours.add(torch.from_numpy(x) if kind == "torch" else x, b, "m")
        theirs.add(x, b, "m")
    ours.save()
    theirs.save()
    for a, w in ((ours.feature_locations["m"], theirs.feature_locations["m"]),
                 (ours.feature_activations["m"], theirs.feature_activations["m"])):
        assert a.dtype == w.dtype and a.shape == w.shape and a.tobytes() == w.tobytes()
    assert len(ours.feature_activations["m"]) > 0
    loc, acts = ours.get_nonzeros(torch.from_numpy(_latents(7)), "m")
    want_loc, want_acts = theirs.get_nonzeros(_latents(7), "m")
    np.testing.assert_array_equal(loc, want_loc)
    assert acts.tobytes() == want_acts.tobytes()


@pytest.mark.parametrize("drop", [False, True], ids=["keep boundary", "replicate boundary drop"])
def test_save_and_save_splits_byte_equal_to_jax(tmp_path, drop):
    filters = {"layers.1": np.array([3, 15, 31, 40, 63])}
    for name, (fc, other) in (("unfiltered", _caches()), ("filtered", _caches(filters))):
        assert set(fc.submodule_dict) == set(other.submodule_dict)
        for pkg, cache in (("port", fc), ("jax", other)):
            for b in range(3):
                for hook in cache.submodule_dict:
                    cache.cache.add(_latents(10 * b + len(hook)), b, hook)
            cache.cache.save()
            out = tmp_path / name / pkg
            out.mkdir(parents=True)
            cache.save(str(out))
            cache.save_splits(N_SPLITS, str(out / "splits"), replicate_boundary_drop=drop)
            cache.save_splits(N_SPLITS, str(out / "merged"), rank=1, replicate_boundary_drop=drop)
            cache.concate_safetensors(N_SPLITS, str(out / "merged"))
        port, jax_ = _digests(tmp_path / name / "port"), _digests(tmp_path / name / "jax")
        assert port == jax_
        modules = sorted(fc.submodule_dict)
        assert sum(f.endswith(".featidx") for f in port) == N_SPLITS * len(modules)
        assert sorted(f for f in port if "/" not in f) == [f"{m}.safetensors" for m in modules]
    # Only the boundary features differ between the two modes.
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    feats = load_file(str(tmp_path / "unfiltered" / "port" / "merged" / "layers.0" / "0_15.safetensors"))
    assert (15 in feats["locations"][:, 2].tolist()) == (not drop)


def test_streaming_refuses_the_boundary_drop(tmp_path):
    for fc in _caches():
        fc.enable_streaming(str(tmp_path / type(fc).__module__), N_SPLITS)
        with pytest.raises(ValueError, match="boundary"):
            fc.save_splits(N_SPLITS, str(tmp_path / type(fc).__module__), replicate_boundary_drop=True)
        fc._stream.abort()


def test_process_batch_equals_the_run_loop():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    sae = Sae(8, SaeConfig(num_latents=WIDTH, k=4), device="cpu", seed=2)
    rows = [{"input_ids": rng.integers(0, 30, size=6)} for _ in range(6)]

    def capture(b):
        return {"m": table[torch.as_tensor(b["input_ids"])], "other": table[:1]}

    a, b = (FeatureCache(capture, {"m": sae}, batch_size=2) for _ in range(2))
    a.run(6, rows, progress=False)
    for i in range(3):
        b.process_batch({"input_ids": np.stack([r["input_ids"] for r in rows[2 * i: 2 * i + 2]])}, i)
    b.cache.save()
    assert a.cache.feature_locations["m"].tobytes() == b.cache.feature_locations["m"].tobytes()
    assert a.cache.feature_activations["m"].tobytes() == b.cache.feature_activations["m"].tobytes()
    assert len(b.cache.feature_activations["m"]) == 6 * 6 * 4
    b.filter_submodules({"x": [1]})
    assert b.submodule_dict == {}
