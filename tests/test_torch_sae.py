"""The PyTorch port's SAE against the JAX package: `pre_acts` and `encode`
on the same weights (carried by `convert.py`) and inputs, fp32, within 1e-5
(matmuls summed in different orders); top-k compared as sets, allowing a
swap only where the JAX-side k-th and (k+1)-th latents lie within that
tolerance.  Checkpoints: `save_to_disk` bytes equal across the packages, and
each loads the other's files; the port's safetensors writer equals the
`safetensors` package byte for byte."""

import hashlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu.sae.model import encode as jax_encode
from multimodal_sae_tpu.sae.model import pre_acts as jax_pre_acts
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax, sae_params_to_jax
from multimodal_sae_tpu_torch.sae import Sae, encode, pre_acts
from multimodal_sae_tpu_torch.utils.safetensors_io import load_file, save_file

RTOL = 1e-5


def _digests(d):
    return {
        f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
        for f in sorted(os.listdir(d))
    }


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def pair():
    """One SAE (d_in 64, 32,768 latents, k=128) in both packages, with a
    nonzero b_enc and b_dec so every term of pre_acts shows."""
    jsae = JaxSae(64, JaxSaeConfig(num_latents=32768, k=128), key=jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    jsae.params["b_enc"] = jnp.asarray(rng.normal(scale=0.05, size=32768).astype(np.float32))
    jsae.params["b_dec"] = jnp.asarray(rng.normal(scale=0.1, size=64).astype(np.float32))
    sae = Sae(64, SaeConfig(num_latents=32768, k=128),
              params=sae_params_from_jax(_np_params(jsae.params), device="cpu"))
    x = rng.normal(size=(3, 11, 64)).astype(np.float32)
    return jsae, sae, x


def test_pre_acts_matches_jax(pair):
    jsae, sae, x = pair
    ref = np.asarray(jax_pre_acts(jsae.params, jnp.asarray(x)))
    got = pre_acts(sae.params, torch.from_numpy(x))
    assert got.shape == (3, 11, 32768) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6)


def test_encode_matches_jax_tie_aware(pair):
    jsae, sae, x = pair
    jv, ji = jax_encode(jsae.params, jnp.asarray(x), jsae.cfg)
    tv, ti = encode(sae.params, torch.from_numpy(x), sae.cfg)
    assert ti.dtype == torch.int32 and tv.shape == (3, 11, 128)
    pre = np.asarray(jax_pre_acts(jsae.params, jnp.asarray(x))).reshape(-1, 32768)
    top = -np.sort(-pre, axis=-1)[:, :129]
    near_tie = top[:, 127] - top[:, 128] <= RTOL * np.abs(top[:, 127])
    jv, ji = np.asarray(jv).reshape(-1, 128), np.asarray(ji).reshape(-1, 128)
    tv, ti = tv.reshape(-1, 128).numpy(), ti.reshape(-1, 128).numpy()
    n_swapped = 0
    for r in range(len(pre)):
        if set(ti[r]) != set(ji[r]):
            assert near_tie[r], f"token {r}: index sets differ without a near tie"
            n_swapped += 1
            continue
        np.testing.assert_allclose(tv[r][np.argsort(ti[r])], jv[r][np.argsort(ji[r])], rtol=RTOL, atol=1e-6)
    assert n_swapped <= 0.01 * len(pre)


def test_sae_files_byte_equal_and_load_both_ways(tmp_path):
    cfg_kw = dict(expansion_factor=2, k=2)
    jsae = JaxSae(8, JaxSaeConfig(**cfg_kw), key=jax.random.PRNGKey(0))
    jsae.save_to_disk(tmp_path / "jax")

    # The JAX package's files load in the port, and save back byte-equal.
    port = Sae.load_from_disk(tmp_path / "jax", device="cpu")
    for name, ref in _np_params(jsae.params).items():
        np.testing.assert_array_equal(port.params[name].numpy(), ref)
    port.save_to_disk(tmp_path / "port")
    assert _digests(tmp_path / "port") == _digests(tmp_path / "jax")

    # Weights carried by convert.py save byte-equal too, and convert back.
    carried = Sae(8, SaeConfig(**cfg_kw), params=sae_params_from_jax(_np_params(jsae.params), "cpu"))
    carried.save_to_disk(tmp_path / "carried")
    assert _digests(tmp_path / "carried") == _digests(tmp_path / "jax")
    for name, a in sae_params_to_jax(carried.params).items():
        np.testing.assert_array_equal(a, np.asarray(jsae.params[name]))

    # A port-initialised SAE loads in the JAX package and round-trips.
    fresh = Sae(8, SaeConfig(**cfg_kw), seed=3, device="cpu")
    fresh.save_to_disk(tmp_path / "fresh")
    back = JaxSae.load_from_disk(tmp_path / "fresh")
    for name, t in fresh.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[name]), t.numpy())
    back.save_to_disk(tmp_path / "back")
    assert _digests(tmp_path / "back") == _digests(tmp_path / "fresh")
    np.testing.assert_allclose(torch.linalg.vector_norm(fresh.W_dec, dim=1).numpy(), 1.0, rtol=1e-6)

    enc_only = Sae.load_from_disk(tmp_path / "jax", decoder=False, device="cpu")
    assert "W_dec" not in enc_only.params


def test_load_many_natsorted(tmp_path):
    for i in (10, 2, 1):
        Sae(8, SaeConfig(expansion_factor=2, k=2), seed=i, device="cpu").save_to_disk(tmp_path / f"layers.{i}")
    assert list(Sae.load_many(str(tmp_path), device="cpu")) == ["layers.1", "layers.2", "layers.10"]


def test_safetensors_writer_byte_equal_to_the_package(tmp_path):
    from safetensors.numpy import save_file as st_numpy_save
    from safetensors.torch import save_file as st_torch_save

    rng = np.random.default_rng(0)
    arrays = {
        "locations": rng.integers(0, 1 << 40, size=(7, 3)).astype(np.int64),
        "activations": rng.normal(size=7).astype(np.float32),
        "meta": np.array([7, 99], np.int64),
        "order": np.arange(5, dtype=np.int32),
        "empty": np.zeros((0, 3), np.int64),
        "scalar": np.array(3.5, np.float64),
    }
    st_numpy_save(arrays, str(tmp_path / "ref.st"))
    save_file(arrays, tmp_path / "port.st")
    assert (tmp_path / "ref.st").read_bytes() == (tmp_path / "port.st").read_bytes()
    back = load_file(tmp_path / "ref.st")
    assert all(np.array_equal(back[k].numpy(), v) for k, v in arrays.items())

    tensors = {
        "w": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).bfloat16(),
        "b": torch.from_numpy(rng.normal(size=4).astype(np.float32)).bfloat16(),
        "i": torch.arange(6),
        "f": torch.from_numpy(rng.normal(size=2).astype(np.float32)),
    }
    st_torch_save(tensors, str(tmp_path / "ref_t.st"), metadata={"format": "pt"})
    save_file(tensors, tmp_path / "port_t.st", metadata={"format": "pt"})
    assert (tmp_path / "ref_t.st").read_bytes() == (tmp_path / "port_t.st").read_bytes()
    back = load_file(tmp_path / "ref_t.st")
    assert all(torch.equal(back[k], v) for k, v in tensors.items())
