"""int8 quantisation in the port (models/quant.py) against the JAX package
(multimodal_sae_tpu/models/quant.py), on the CPU.

* Quantised weights equal the JAX package's bit for bit: every LLaMA
  projection (transposed), the LM head and the embedding of the tiny LLaMA,
  every CLIP leaf of the tiny LLaVA's tower, and an SAE encoder.
* One `qmatmul`: W8A8 on rows that lie on an int8 grid (JAX
  tests/test_quant.py:141's construction) equals the JAX product bit for
  bit; on general rows the int32 sums equal an int64 product and the
  outputs agree within fp32 rounding; W8A16 on bf16 rows within one bf16
  step of JAX; the straight-through gradient within fp32 rounding of
  JAX's; a zero row gives zeros; a padded call (3 rows, k = 588, n = 36)
  equals the unpadded int64 product.
* The quantised subjects against the JAX package's quantised subjects (not
  against fp32: W8A8 moves top-k ties), in bf16 as both run them: the tiny
  LLaMA's logits and captures under W8A16 and W8A8 within REL of the
  largest magnitude, the tiny LLaVA's with and without `int8_vision`;
  greedy tokens up to the first step whose JAX top-2 gap is under
  NEAR_TIE; an attribution input gradient through the straight-through
  products that is finite and nonzero.
* The int8 SAE encoder: the text cache CLI with `--sae_int8` writes splits
  byte-equal to the JAX CLI's, on an exact grid (every row of x - b_dec and
  every latent's encoder column on an int8 grid with a power-of-two step,
  so the W8A8 products, and their sums with the biases, are exact on both
  sides whatever the order or fusion); the training forward refuses a quantised encoder, as the
  JAX forward does.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import CacheConfig as JaxCacheConfig
from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.models import SyntheticActivationSource as JaxSource
from multimodal_sae_tpu.models import llama as jl
from multimodal_sae_tpu.models import quant as jq
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu.sae import forward as jax_forward
from multimodal_sae_tpu.sae.model import quantize_encoder as jax_quantize_encoder
from multimodal_sae_tpu_torch.config import CacheConfig, SaeConfig
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, llava_params_from_jax, sae_params_from_jax
from multimodal_sae_tpu_torch.models import SyntheticActivationSource
from multimodal_sae_tpu_torch.models import llama as pl
from multimodal_sae_tpu_torch.models import quant as q
from multimodal_sae_tpu_torch.sae import Sae, forward

from torch_llama_tiny import TINY, numpy_params
from torch_llava_tiny import BOS, IMG_TOKEN, images
from torch_llava_tiny import models as llava_models

REL = {False: 2.0**-5, True: 2.0**-4}
"""Quantised forwards in bf16 against JAX's, |port - jax| <= REL * max|jax|:
W8A16 a couple of bf16 steps (the two sides round in their own orders);
W8A8 twice that, since a bf16 step in an activation can move its row's
int8 rounding."""
NEAR_TIE = 0.125  # bf16 logits: a top-2 gap under this may flip
MIN_STEPS = 6


def _equal(got: torch.Tensor, want) -> bool:
    want = torch.from_numpy(np.array(want))  # a writable copy of the JAX array
    return got.dtype == want.dtype and torch.equal(got, want)


def _leaf_equal(got, want, transpose: bool) -> bool:
    if jq.is_quantized(want):
        q8 = np.asarray(want["q8"])
        return _equal(got["q8"], q8.T if transpose else q8) and _equal(got["scale"], want["scale"])
    want = np.array(want)
    if got.dtype == torch.bfloat16:
        return torch.equal(got.view(torch.uint16), torch.from_numpy(want.view(np.uint16)))
    return torch.equal(got, torch.from_numpy(want))


@pytest.fixture(scope="module")
def llama_pair():
    """(JAX quantised params, port quantised params) of the tiny LLaMA, each
    quantised by its own package from the same fp32 weights."""
    dense = numpy_params(0)
    jparams = jq.quantize_llama_params(jax.tree_util.tree_map(jnp.asarray, dense))
    return jparams, q.quantize_llama_params(llama_params_from_jax(dense, device="cpu"))


def test_llama_weights_equal_jax_bit_for_bit(llama_pair):
    jparams, params = llama_pair
    assert _leaf_equal(params["embed_tokens"], jparams["embed_tokens"], transpose=False)
    assert params["embed_tokens"]["scale"].shape == (TINY["hidden_size"],)
    assert _leaf_equal(params["lm_head"], jparams["lm_head"], transpose=True)
    assert params["lm_head"]["scale"].shape == (TINY["vocab_size"],)
    assert _leaf_equal(params["norm"], jparams["norm"], transpose=False) and params["norm"].dtype == torch.bfloat16
    for got, want in zip(params["layers"], jparams["layers"]):
        assert got.keys() == want.keys()
        for name in got:
            assert _leaf_equal(got[name], want[name], transpose=name in q.LLAMA_QUANT_KEYS), name
    assert q.leaf_bytes(params) < 0.3 * q.leaf_bytes(llama_params_from_jax(numpy_params(0), device="cpu"))


@pytest.fixture(scope="module")
def llava_pair():
    """(JAX LLaVA params quantised by the JAX package, the port's quantised
    by the port) of the tiny LLaVA, and the two models' configs."""
    jmodel, model = llava_models(seed=0)
    jparams = dict(jmodel.params, language_model=jq.quantize_llama_params(jmodel.params["language_model"]),
                   vision_tower=jq.quantize_clip_params(jmodel.params["vision_tower"]))
    params = llava_params_from_jax(jmodel.params, device="cpu")
    q.quantize_llama_params(params["language_model"])
    q.quantize_clip_params(params["vision_tower"])
    return jmodel, model, jparams, params


def test_clip_weights_equal_jax_bit_for_bit(llava_pair):
    from multimodal_sae_tpu_torch.convert import CLIP_MATRICES

    _, _, jparams, params = llava_pair
    got, want = params["vision_tower"], jparams["vision_tower"]
    assert got.keys() == want.keys()
    for name in got:
        if name != "layers":
            assert _leaf_equal(got[name], want[name], transpose=name in CLIP_MATRICES), name
    assert q.is_quantized(got["patch_embedding"]) and got["patch_embedding"]["q8"].shape[1] == 3 * 16 * 16
    for layer, jlayer in zip(got["layers"], want["layers"]):
        for name in layer:
            assert _leaf_equal(layer[name], jlayer[name], transpose=name in CLIP_MATRICES), name


def test_sae_encoder_equal_jax_bit_for_bit():
    jsae = JaxSae(16, JaxSaeConfig(expansion_factor=4, k=4), key=jax.random.PRNGKey(3))
    want = jax_quantize_encoder(jsae.params)["W_enc"]
    sae = Sae(16, SaeConfig(expansion_factor=4, k=4), params=sae_params_from_jax(jsae.params, "cpu"))
    assert sae.dtype == torch.float32
    sae.quantize_encoder()
    assert sae.dtype == torch.bfloat16
    assert _leaf_equal(sae.params["W_enc"], want, transpose=True)
    assert set(sae.params) == {"W_enc", "b_enc", "W_dec", "b_dec"}
    converted = sae_params_from_jax(jax_quantize_encoder(jsae.params), "cpu")["W_enc"]
    assert torch.equal(converted["q8"], sae.params["W_enc"]["q8"])


# ---- one product ----------------------------------------------------------------


def _weight(seed, k, n):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)  # JAX layout (in, out)
    return jq.quantize_weight(jnp.asarray(w)), q.quantize_weight(torch.from_numpy(w.T.copy()))


def test_w8a8_on_int8_grid_rows_equals_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    xq = rng.integers(-127, 128, size=(8, 32)).astype(np.float32)
    xq[:, 0] = 127  # each row's absmax pinned, so sx is the step exactly
    x = xq * 0.03125
    jw, w = _weight(2, 32, 16)
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jw, int8=True))
    got = q.qmatmul(torch.from_numpy(x), w, int8=True)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_w8a8_general_rows_exact_sums_and_fp32_outputs():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    jw, w = _weight(3, 64, 32)
    xq, sx = q.quantize_rows(torch.from_numpy(x))
    acc = q.int8_mm(xq, w["q8"])
    assert acc.dtype == torch.int32 and torch.equal(acc.long(), xq.long() @ w["q8"].long().t())
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jw, int8=True))
    np.testing.assert_allclose(q.qmatmul(torch.from_numpy(x), w, int8=True).numpy(), want, rtol=1e-6, atol=1e-6)


def test_w8a16_within_a_bf16_step_of_jax():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(12, 64)).astype(np.float32)).astype(jnp.bfloat16)
    jw, w = _weight(5, 64, 40)
    want = np.asarray(jq.qmatmul(x, jw)).astype(np.float32)
    got = q.qmatmul(torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16(), w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-6)  # one bf16 step
    # fp32 rows: fp32 sums of exact products, then the scale.
    x32 = rng.normal(size=(12, 64)).astype(np.float32)
    np.testing.assert_allclose(q.qmatmul(torch.from_numpy(x32), w).numpy(),
                               np.asarray(jq.qmatmul(jnp.asarray(x32), jw)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("int8", [True, False], ids=["w8a8", "w8a16"])
def test_straight_through_gradient_equals_jax(int8):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(10, 48)).astype(np.float32)
    g = rng.normal(size=(10, 24)).astype(np.float32)
    jw, w = _weight(7, 48, 24)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jq.qmatmul(a, jw, int8=int8) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (q.qmatmul(xt, w, int8=int8) * torch.from_numpy(g)).sum().backward()
    # Both sides: (g * scale), in bf16 for W8A8 and fp32 for W8A16, times
    # q8 with fp32 sums.
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want).max() > 0


def test_zero_row_gives_zeros():
    _, w = _weight(8, 8, 8)
    x = torch.zeros(4, 8)
    x[1] = 1.0
    out = q.qmatmul(x, w, int8=True)
    assert torch.all(out[[0, 2, 3]] == 0) and bool(out[1].abs().sum() > 0)


def test_padded_call_equals_the_unpadded_int64_product():
    """3 rows (the card needs 17), k = 588 (CLIP-L/336's patch embedding)
    and n = 36 (multiples of 8 needed): padded with zeros, cut back."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 588)).astype(np.float32))
    w = q.quantize_weight(torch.from_numpy(rng.normal(size=(36, 588)).astype(np.float32)))
    xq, sx = q.quantize_rows(x)
    acc = q.int8_mm(xq, w["q8"])
    want = xq.long() @ w["q8"].long().t()
    assert acc.shape == (3, 36) and torch.equal(acc.long(), want)
    assert torch.equal(q.qmatmul(x, w, int8=True), want.float() * sx * w["scale"])
    with pytest.raises(ValueError, match="int8 product"):
        q.int8_mm(xq[:, :580], w["q8"])


# ---- the subjects ------------------------------------------------------------------


def _close(got: torch.Tensor, want, int8: bool, what: str):
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().detach().numpy() - want).max()
    assert err <= REL[int8] * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("int8", [False, True], ids=["w8a16", "w8a8"])
def test_quantized_llama_forward_matches_jax(llama_pair, int8):
    jparams, params = llama_pair
    ids = np.random.default_rng(1).integers(0, TINY["vocab_size"], size=(2, 12))
    jout = jl.LlamaModel(jparams, jl.LlamaConfig(**TINY, int8_matmul=int8)).forward(
        {"input_ids": ids}, capture=["layers.0", "layers.2"])
    model = pl.LlamaModel(params, pl.LlamaConfig(**TINY, int8_matmul=int8))
    out = model.forward({"input_ids": ids}, capture=["layers.0", "layers.2"])
    assert out["logits"].dtype == torch.bfloat16 and model.device.type == "cpu"
    _close(out["logits"], jout["logits"], int8, "logits")
    for hook in ("layers.0", "layers.2"):
        _close(out["captured"][hook], jout["captured"][hook], int8, hook)


@pytest.mark.parametrize("int8", [False, True], ids=["w8a16", "w8a8"])
def test_quantized_llama_greedy_tokens_match_jax(llama_pair, int8):
    jparams, params = llama_pair
    jcfg, cfg = jl.LlamaConfig(**TINY, int8_matmul=int8), pl.LlamaConfig(**TINY, int8_matmul=int8)
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], size=(2, 8))[1:]  # bf16 ties are common
    new = 10
    ref = np.asarray(jl.greedy_generate(jparams, jcfg, jnp.asarray(ids), max_new_tokens=new))
    got = pl.greedy_generate(params, cfg, ids, max_new_tokens=new).numpy()
    # The JAX side's top-2 gaps from one cache-free forward over its tokens.
    logits = np.asarray(jl.LlamaModel(jparams, jcfg).forward({"input_ids": ref})["logits"]).astype(np.float32)
    top2 = np.sort(logits[:, ids.shape[1] - 1:-1], axis=-1)[..., -2:]
    ties = np.nonzero((top2[..., 1] - top2[..., 0] < NEAR_TIE).any(axis=0))[0]
    steps = int(ties[0]) if len(ties) else new
    assert steps >= MIN_STEPS, f"a near tie at step {steps}"
    np.testing.assert_array_equal(got[:, :ids.shape[1] + steps], ref[:, :ids.shape[1] + steps])


def test_attribution_gradient_through_int8_products_is_finite(llama_pair):
    """The suffix forward of attribution over the W8A8 subject: the
    gradient at the splice flows through the straight-through products."""
    _, params = llama_pair
    cfg = pl.LlamaConfig(**TINY, int8_matmul=True)
    ids = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(2, 9))
    hidden = pl.LlamaModel(params, cfg).capture({"input_ids": ids}, ["layers.0"])["layers.0"]
    hidden = hidden.detach().requires_grad_(True)
    logits = pl.forward_from_layer_above(params, cfg, hidden, 0)
    logits[:, -1, 7].sum().backward()
    grad = hidden.grad.float()
    assert grad.shape == hidden.shape and bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0)


@pytest.mark.parametrize("vision", [False, True], ids=["w8a16-tower", "int8-vision"])
def test_quantized_llava_matches_jax(llava_pair, vision):
    from multimodal_sae_tpu.models import llava_next as jln
    from multimodal_sae_tpu_torch.models import llava_next as pln

    jmodel, model, jparams, params = llava_pair

    def with_flags(cfg):
        return dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, int8_matmul=True),
                                   vision_config=dataclasses.replace(cfg.vision_config, int8_matmul=vision))

    jq_model = jln.LlavaNextModel(jparams, with_flags(jmodel.cfg))
    q_model = pln.LlavaNextModel(params, with_flags(model.cfg))
    imgs = images([(50, 70), (40, 60)], seed=5)
    prompts = [[BOS, IMG_TOKEN, 11, 12], [BOS, 13, IMG_TOKEN, 14]]
    batch = q_model.prepare_inputs(images=imgs, prompt_ids=prompts)
    hooks = ["model.layers.0", "model.layers.2"]
    got = q_model.forward(batch, capture=hooks)
    want = jq_model.forward(jq_model.prepare_inputs(images=imgs, prompt_ids=prompts), capture=hooks)
    _close(got["logits"], want["logits"], True, "logits")
    for hook in hooks:
        _close(got["captured"][hook], want["captured"][hook], True, hook)


# ---- the int8 SAE encoder ----------------------------------------------------------


def test_sae_int8_text_cache_cli_is_byte_equal_to_jax(tmp_path, monkeypatch):
    from datasets import Dataset

    from multimodal_sae_tpu.launch.cache import cache as jax_cli
    from multimodal_sae_tpu_torch.launch.cache import cache as port_cli

    d, width = 16, 64
    rng = np.random.default_rng(2)
    steps = rng.integers(-127, 128, size=(64, d))
    steps[:, 0] = rng.choice([-127, 127], size=64)  # every row's absmax is 127 steps
    embed = (steps / 32).astype(np.float32)  # layers.0 of the source is the embedding: x - b_dec on the grid
    ids = np.random.default_rng(3).integers(0, 64, size=(16, 8))
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(tmp_path / "ds"))
    w_steps = rng.integers(-127, 128, size=(d, width))
    w_steps[0] = rng.choice([-127, 127], size=width)  # every latent's scale is 2^-7
    params = {
        "W_enc": (w_steps / 128).astype(np.float32),
        "b_enc": (-0.5 + np.arange(width) * 2.0**-16).astype(np.float32),
        "W_dec": (rng.integers(-8, 9, size=(width, d)) / 16).astype(np.float32),
        "b_dec": np.zeros(d, np.float32),
    }
    sae = JaxSae(d, JaxSaeConfig(num_latents=width, k=4), key=jax.random.PRNGKey(0))
    sae.params = {name: jnp.asarray(a) for name, a in params.items()}
    sae.save_to_disk(tmp_path / "saes" / "layers.0")

    def jax_source(cls, uri):
        src = JaxSource(d_model=d, n_layers=2, vocab=64)
        src.embed = jnp.asarray(embed)
        return src

    quantized = []
    quantize_encoder = Sae.quantize_encoder
    monkeypatch.setattr(Sae, "quantize_encoder", lambda sae: quantized.append(sae) or quantize_encoder(sae))
    monkeypatch.setattr(JaxSource, "from_spec", classmethod(jax_source))
    monkeypatch.setattr(SyntheticActivationSource, "from_spec", classmethod(
        lambda cls, uri, device=None: cls(d_model=d, n_layers=2, vocab=64, embed=embed, device=device)))
    kw = dict(model="synthetic://16,2,64", dataset=str(tmp_path / "ds"), sae_path=str(tmp_path / "saes"),
              batch_size=2, ctx_len=8, n_splits=2, sae_int8=True)
    jax_cli.main(JaxCacheConfig(save_dir=str(tmp_path / "jax"), **kw))
    port_cli.main(CacheConfig(save_dir=str(tmp_path / "port"), **kw), device="cpu")
    files = sorted(os.listdir(tmp_path / "jax" / "layers.0"))
    assert files == sorted(os.listdir(tmp_path / "port" / "layers.0")) and len(files) >= 2
    for f in files:
        assert (tmp_path / "port" / "layers.0" / f).read_bytes() == (tmp_path / "jax" / "layers.0" / f).read_bytes(), f
    assert len(quantized) == 1 and quantized[0].dtype == torch.bfloat16


def test_training_forward_refuses_a_quantized_encoder():
    jsae = JaxSae(16, JaxSaeConfig(expansion_factor=4, k=4), key=jax.random.PRNGKey(1))
    x = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    with pytest.raises(AssertionError, match="dense encoder"):
        jax_forward(jax_quantize_encoder(jsae.params), jnp.asarray(x), jsae.cfg)
    sae = Sae(16, SaeConfig(expansion_factor=4, k=4), params=sae_params_from_jax(jsae.params, "cpu"))
    sae.quantize_encoder()
    with pytest.raises(ValueError, match="dense encoder"):
        forward(sae.params, torch.from_numpy(x), sae.cfg)
    with pytest.raises(ValueError, match="dense encoder"):
        sae.forward(torch.from_numpy(x))
