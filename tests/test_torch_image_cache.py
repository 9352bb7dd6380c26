"""The port's image cache (`FeatureImageCache`, the `cache_image` CLI)
against the JAX package's, on the tiny LLaVA-NeXT of tests/torch_llava_tiny.py.

(a) Byte for byte: both packages' `FeatureImageCache` fed the same captured
    hiddens (the port's capture, rounded onto a grid of 1/8) and an SAE whose
    weights lie on a grid too, so every encoder product and sum is exact in
    fp32 in any order and each latent is distinct (a bias of j·2^-16 on
    latent j); the merged splits and `.featidx` sidecars are byte-equal.
(b) The slice end to end: each package's own subject, capture and encoder,
    fp32, on batches that mix geometries (right-padded rows, whose pad
    positions are cached as in the JAX package).  Activations agree within
    rtol 1e-5 and per token the index sets are equal, except at tokens whose
    JAX-side k-th and (k+1)-th latents lie within 1e-5 relative, which must be
    under 1% of the tokens.
(c) The CLIs on one tiny checkpoint with its processor and tokenizer,
    written offline here: the port's against the JAX package's as in (b), and
    against the port's own library path byte for byte.
"""

import functools
import hashlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import CacheConfig as JaxCacheConfig
from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.cache import FeatureImageCache as JaxFeatureImageCache
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu.sae.model import pre_acts as jax_pre_acts
from multimodal_sae_tpu_torch.config import CacheConfig, SaeConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.features import FeatureImageCache
from multimodal_sae_tpu_torch.sae import Sae
from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

from torch_llava_tiny import BOS, IMG_TOKEN, images, models, write_checkpoint

HOOK = "model.layers.1"
RTOL = 1e-5
WIDTH, K = 256, 8
PROMPT = [BOS, IMG_TOKEN]
SIZES = [(50, 70), (90, 40), (64, 64), (40, 50), (30, 100), (50, 70)]


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest() for f in sorted(os.listdir(d))}


def _merged(d):
    files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    assert files and not any(f.startswith("Rank") for f in files)
    data = [load_file(os.path.join(d, f)) for f in files]
    return (np.concatenate([x["locations"].numpy() for x in data]),
            np.concatenate([x["activations"].numpy() for x in data]))


def _run(cls, capture_fn, sae, out, rows, shard_size=0):
    fc = cls(capture_fn, {HOOK: sae}, batch_size=2, shard_size=shard_size)
    fc.enable_streaming(str(out), 4)
    fc.run(64, rows, progress=False)
    fc.save_splits(4, str(out))
    fc.concate_safetensors(4, str(out))


@pytest.fixture(scope="module")
def pair():
    return models(seed=0)


def _port_capture(model):
    def capture_fn(batch):
        prepared = model.prepare_inputs(images=list(batch["image"]), prompt_ids=[PROMPT] * len(batch["image"]))
        return model.capture(prepared, [HOOK])

    return capture_fn


def _jax_capture(jmodel):
    def capture_fn(batch):
        prepared = jmodel.prepare_inputs(images=list(batch["image"]), prompt_ids=[PROMPT] * len(batch["image"]))
        return jmodel.capture(prepared, [HOOK])

    return capture_fn


# ---- (a) byte for byte ------------------------------------------------------------


def _grid_sae(d_in=64, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "W_enc": (rng.integers(-8, 9, size=(d_in, WIDTH)) / 16).astype(np.float32),
        "b_enc": (-0.5 + np.arange(WIDTH) * 2.0**-16).astype(np.float32),
        "W_dec": np.zeros((WIDTH, d_in), np.float32),
        "b_dec": (rng.integers(-4, 5, size=d_in) / 8).astype(np.float32),
    }


def test_splits_byte_equal_to_jax(pair, tmp_path):
    _, model = pair
    rows = [{"image": im} for im in images(SIZES, seed=2)]
    port_capture = _port_capture(model)

    def grid_hiddens(batch):
        h = port_capture(batch)[HOOK].numpy()
        return np.clip(np.round(h * 8) / 8, -2, 2).astype(np.float32)

    params = _grid_sae()
    jsae = JaxSae(64, JaxSaeConfig(num_latents=WIDTH, k=K), key=jax.random.PRNGKey(0))
    jsae.params = {name: jnp.asarray(a) for name, a in params.items()}
    sae = Sae(64, SaeConfig(num_latents=WIDTH, k=K), params=sae_params_from_jax(params, "cpu"))
    _run(JaxFeatureImageCache, lambda b: {HOOK: jnp.asarray(grid_hiddens(b))}, jsae, tmp_path / "jax", rows, 10)
    _run(FeatureImageCache, lambda b: {HOOK: torch.from_numpy(grid_hiddens(b))}, sae, tmp_path / "port", rows, 10)
    port_files = _digests(tmp_path / "port" / HOOK)
    assert len(port_files) == 8 and port_files == _digests(tmp_path / "jax" / HOOK)
    locs, acts = _merged(tmp_path / "port" / HOOK)
    assert len(acts) > 0 and set(locs[:, 0]) == set(range(10, 16))
    # BOS dropped: the first image row's positions run 0 .. S - 2.
    seq = model.prepare_inputs(images=[rows[0]["image"], rows[1]["image"]], prompt_ids=[PROMPT] * 2)["input_ids"].shape[1]
    assert locs[locs[:, 0] == 10, 1].max() == seq - 2


def test_run_refuses_extra_kwargs(pair):
    _, model = pair
    sae = Sae(64, SaeConfig(num_latents=WIDTH, k=K), seed=0, device="cpu")
    fc = FeatureImageCache(_port_capture(model), {HOOK: sae}, batch_size=2)
    with pytest.raises(TypeError, match="BOS"):
        fc.run(64, [], progress=False, skip_bos=False)


# ---- (b) the slice end to end -----------------------------------------------------


@pytest.fixture(scope="module")
def jax_sae():
    return JaxSae(64, JaxSaeConfig(num_latents=WIDTH, k=K), key=jax.random.PRNGKey(3))


def _by_token(locs, acts):
    out = {}
    for (row, pos, feat), a in zip(locs.tolist(), acts.tolist()):
        out.setdefault((row, pos), {})[feat] = a
    return out


def _assert_same_cache(port_dir, jax_dir, jax_hiddens, jsae, row_offset):
    """`jax_hiddens`: the JAX capture of each batch with its BOS dropped."""
    ref, port = _by_token(*_merged(jax_dir)), _by_token(*_merged(port_dir))
    assert set(port) == set(ref) and len(ref) > 0
    near_tie = {}
    for b, h in enumerate(jax_hiddens):
        pre = np.asarray(jax_pre_acts(jsae.params, jnp.asarray(h.reshape(-1, h.shape[-1]))))
        top = -np.sort(-pre, axis=-1)[:, : K + 1]
        tie = top[:, K - 1] - top[:, K] <= RTOL * np.abs(top[:, K - 1])
        for i, t in enumerate(tie.reshape(h.shape[0], h.shape[1])):
            for s, v in enumerate(t):
                near_tie[(row_offset + 2 * b + i, s)] = v
    swapped = 0
    for key, feats in ref.items():
        got = port[key]
        if set(got) != set(feats):
            assert near_tie[key], f"token {key}: sets differ without a near tie"
            swapped += 1
            continue
        f = sorted(feats)
        np.testing.assert_allclose([got[i] for i in f], [feats[i] for i in f], rtol=RTOL, atol=0)
    assert swapped < 0.01 * len(ref)


def test_feature_image_cache_run_matches_jax(pair, jax_sae, tmp_path):
    jmodel, model = pair
    imgs = images(SIZES, seed=4)
    rows = [{"image": im} for im in imgs]
    sae = Sae(64, SaeConfig(num_latents=WIDTH, k=K), params=sae_params_from_jax(
        {k: np.asarray(v) for k, v in jax_sae.params.items()}, "cpu"))
    _run(JaxFeatureImageCache, _jax_capture(jmodel), jax_sae, tmp_path / "jax", rows, 4)
    _run(FeatureImageCache, _port_capture(model), sae, tmp_path / "port", rows, 4)
    hiddens = [np.asarray(_jax_capture(jmodel)({"image": imgs[i : i + 2]})[HOOK])[:, 1:] for i in range(0, 6, 2)]
    _assert_same_cache(tmp_path / "port" / HOOK, tmp_path / "jax" / HOOK, hiddens, jax_sae, row_offset=4)
    locs, _ = _merged(tmp_path / "port" / HOOK)
    # Every position of every row (pads of the shorter image included) kept
    # all K of its latents, rows offset by shard_size.
    assert len(locs) == sum(h.shape[0] * h.shape[1] for h in hiddens) * K
    assert set(locs[:, 0]) == set(range(4, 10))


# ---- (c) the CLIs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
    """A tiny LLaVA-NeXT checkpoint with its tokenizer and processor
    (`torch_llava_tiny.write_checkpoint`), all loadable offline."""
    return write_checkpoint(tmp_path_factory.mktemp("torch_llava_ckpt"), seed=5)


def test_cache_image_clis_match(llava_dir, jax_sae, tmp_path, monkeypatch):
    """Both CLIs with the same flags (--flash_attention, --truncate_layers
    2).  They load the subject in bf16, whose per-op rounding differs between
    XLA and PyTorch; both are pinned to fp32 here so (b)'s tolerances hold."""
    from datasets import Dataset

    from multimodal_sae_tpu.launch import utils as jax_launch_utils
    from multimodal_sae_tpu.launch.cache import cache_image as jax_cli
    from multimodal_sae_tpu.models.llava_next import LlavaNextModel as JaxLlavaNextModel
    from multimodal_sae_tpu.models.llava_next import load_llava_next as jax_load_llava_next
    from multimodal_sae_tpu_torch.launch import utils as port_launch_utils
    from multimodal_sae_tpu_torch.launch.cache import cache_image as port_cli
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextModel, load_llava_next

    monkeypatch.setattr(jax_cli, "load_subject_model",
                        functools.partial(jax_launch_utils.load_subject_model, dtype=jnp.float32))
    monkeypatch.setattr(port_cli, "load_subject_model",
                        functools.partial(port_launch_utils.load_subject_model, dtype=torch.float32))
    imgs = images(SIZES[:4], seed=6)
    Dataset.from_dict({"image": imgs}).save_to_disk(str(tmp_path / "ds"))
    jax_sae.save_to_disk(tmp_path / "saes" / HOOK)
    flags = dict(model=llava_dir, dataset=str(tmp_path / "ds"), sae_path=str(tmp_path / "saes"),
                 batch_size=2, ctx_len=64, n_splits=4, flash_attention=True, truncate_layers=2)
    jax_cli.main(JaxCacheConfig(save_dir=str(tmp_path / "jax"), **flags))
    port_cli.main(CacheConfig(save_dir=str(tmp_path / "port"), **flags), device="cpu")

    import dataclasses

    jparams, jcfg = jax_load_llava_next(llava_dir, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, text_config=dataclasses.replace(jcfg.text_config, flash_attention=True))
    jmodel = JaxLlavaNextModel(jparams, jcfg)
    hiddens = [np.asarray(_jax_capture(jmodel)({"image": imgs[i : i + 2]})[HOOK])[:, 1:] for i in (0, 2)]
    _assert_same_cache(tmp_path / "port" / HOOK, tmp_path / "jax" / HOOK, hiddens, jax_sae, row_offset=0)
    assert sorted(os.listdir(tmp_path / "port" / HOOK)) == sorted(os.listdir(tmp_path / "jax" / HOOK))

    # The CLI against the library path with the same subject: byte-equal.
    params, cfg = load_llava_next(llava_dir, device="cpu", truncate_layers=2)
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, flash_attention=True))
    sae = Sae.load_from_disk(tmp_path / "saes" / HOOK, decoder=False, device="cpu")
    _run(FeatureImageCache, _port_capture(LlavaNextModel(params, cfg)), sae, tmp_path / "lib",
         [{"image": im} for im in imgs])
    assert _digests(tmp_path / "port" / HOOK) == _digests(tmp_path / "lib" / HOOK)


@pytest.mark.parametrize("flag", [{"int8_matmul": True}, {"load_in_8bit": True}, {"int8_vision": True},
                                  {"sae_int8": True}], ids=lambda f: next(iter(f)))
def test_cache_image_cli_passes_the_int8_flags_on(llava_dir, flag, monkeypatch):
    """The subject's flags reach `load_subject_model`, which quantises the
    tiny LLaVA (`--int8_matmul` implies `--load_in_8bit`), and `--sae_int8`
    reaches `load_saes`; the run stops at the SAEs."""
    from multimodal_sae_tpu_torch.launch.cache import cache_image as port_cli
    from multimodal_sae_tpu_torch.models.quant import is_quantized

    models, sae_flags = [], []
    load = port_cli.load_subject_model

    def recording(*args, **kw):
        models.append(load(*args, **kw)[0])
        return models[-1], None, None

    def stop(*args, **kw):
        sae_flags.append(kw["int8_encoder"])
        raise KeyboardInterrupt

    monkeypatch.setattr(port_cli, "load_subject_model", recording)
    monkeypatch.setattr(port_cli, "load_saes", stop)
    monkeypatch.setattr(port_cli, "load_any_dataset", lambda *a: None)
    with pytest.raises(KeyboardInterrupt):
        port_cli.main(CacheConfig(model=llava_dir, **flag), device="cpu")
    (model,) = models
    quantized = "int8_matmul" in flag or "load_in_8bit" in flag
    assert is_quantized(model.params["language_model"]["embed_tokens"]) == quantized
    assert is_quantized(model.params["vision_tower"]["patch_embedding"]) == quantized
    assert model.cfg.text_config.int8_matmul == ("int8_matmul" in flag)
    assert model.cfg.vision_config.int8_matmul == ("int8_vision" in flag)
    assert sae_flags == ["sae_int8" in flag]


@pytest.mark.parametrize("flag", [{"tp": 2}, {"dp": 2}])
def test_cache_image_cli_refuses_options_of_later_slices(llava_dir, flag):
    from multimodal_sae_tpu_torch.launch.cache import cache_image as port_cli

    # Ported: the subject loader refuses --tp 2 in one process, --dp 2 without two cards.
    with pytest.raises(ValueError, match="world size it divides" if "tp" in flag else "local devices"):
        port_cli.main(CacheConfig(model=llava_dir, **flag), device="cpu")
