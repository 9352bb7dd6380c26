"""The full LLaMA forward of the PyTorch port against the JAX package's, on
the tiny config of tests/test_torch_llama.py (3 layers, hidden 64, 4 heads,
2 kv heads, vocab 128, fp32): logits, interventions, `forward_from_layer`
with and without a pad mask, `suffix_params`, and the LM head
carried across by `convert.py` and loaded from an HF checkpoint.  Weights
come from the JAX package's `init_llama_params`; inputs are numpy-seeded.
Tolerance atol 1e-4: fp32 on both sides, summed in different orders over up
to 3 layers and the vocabulary projection."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models.hf_loader import load_llama as jax_load_llama
from multimodal_sae_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlamaModel
from multimodal_sae_tpu.models.llama import init_llama_params as jax_init_llama_params
from multimodal_sae_tpu.models.llama import pad_text_rows as jax_pad_text_rows
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, llama_params_to_jax
from multimodal_sae_tpu_torch.models.hf_loader import load_llama
from multimodal_sae_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    init_llama_params,
    last_attended,
    pad_text_rows,
)

TOL = dict(rtol=0, atol=1e-4)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def jax_params(request):
    cfg = JaxLlamaConfig(**TINY, tie_word_embeddings=request.param)
    return jax_init_llama_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32), request.param


def _pair(jax_params, flash):
    params, tied = jax_params
    jmodel = JaxLlamaModel(params, JaxLlamaConfig(**TINY, flash_attention=flash, tie_word_embeddings=tied))
    model = LlamaModel(llama_params_from_jax(params, device="cpu"),
                       LlamaConfig(**TINY, flash_attention=flash, tie_word_embeddings=tied))
    return jmodel, model


def _batch(padded):
    ids = np.random.default_rng(0).integers(1, 128, size=(3, 24))
    if not padded:
        return {"input_ids": ids}
    mask = np.ones_like(ids)
    mask[1, :5] = 0
    mask[2, :17] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _real(batch):
    return batch.get("attention_mask", np.ones_like(batch["input_ids"])).astype(bool)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("padded", [False, True], ids=["rectangular", "left-padded"])
def test_logits_match_jax(jax_params, flash, padded):
    """`forward` logits at every real position (pad rows differ between the
    eager and flash masks by design and are never read)."""
    jmodel, model = _pair(jax_params, flash)
    batch = _batch(padded)
    ref = np.asarray(jmodel.forward(batch)["logits"])
    out = model.forward(batch)
    assert out["logits"].shape == (3, 24, 128)
    real = _real(batch)
    np.testing.assert_allclose(out["logits"].detach().numpy()[real], ref[real], **TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_interventions_match_jax(jax_params, flash):
    """An intervention at layers.1 (either hookpoint spelling) replaces that
    layer's output before it is captured and before layer 2 reads it."""
    jmodel, model = _pair(jax_params, flash)
    batch = _batch(False)
    ref = jmodel.forward(batch, capture=("layers.1",),
                         interventions={"model.layers.1": lambda h: h * 0.5 + 1.0})
    out = model.forward(batch, capture=("layers.1",),
                        interventions={"model.layers.1": lambda h: h * 0.5 + 1.0})
    plain = model.forward(batch, capture=("layers.1",))
    torch.testing.assert_close(out["captured"]["layers.1"], plain["captured"]["layers.1"] * 0.5 + 1.0)
    np.testing.assert_allclose(out["captured"]["layers.1"].detach().numpy(),
                               np.asarray(ref["captured"]["layers.1"]), **TOL)
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(ref["logits"]), **TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("padded", [False, True], ids=["rectangular", "left-padded"])
@pytest.mark.parametrize("hook", ["layers.0", "layers.1"])
def test_forward_from_layer_matches_jax(jax_params, flash, padded, hook):
    """From the same hidden state at `hook`: the last attended position's
    logits, equal to the full logits' last attended position, and the full
    logits."""
    jmodel, model = _pair(jax_params, flash)
    batch = _batch(padded)
    hidden = np.random.default_rng(1).normal(size=(3, 24, 64)).astype(np.float32)
    ref_last = np.asarray(jmodel.forward_from_layer(jnp.asarray(hidden), hook, batch))
    ref_full = np.asarray(jmodel.forward_from_layer(jnp.asarray(hidden), hook, batch, last_logit_only=False))
    h = torch.from_numpy(hidden)
    last = model.forward_from_layer(h, hook, batch)
    full = model.forward_from_layer(h, hook, batch, last_logit_only=False)
    assert last.shape == (3, 1, 128)
    np.testing.assert_allclose(last.detach().numpy(), ref_last, **TOL)
    real = _real(batch)
    at_last = real.shape[1] - 1 - np.argmax(real[:, ::-1], axis=1)
    torch.testing.assert_close(last[:, 0], full[np.arange(3), at_last], rtol=0, atol=1e-5)
    np.testing.assert_allclose(full.detach().numpy()[real], ref_full[real], **TOL)


def test_suffix_params_alias_the_layers_above(jax_params):
    _, model = _pair(jax_params, True)
    suffix = model.suffix_params("model.layers.0")
    assert len(suffix["layers"]) == 2
    assert suffix["layers"][0] is model.params["layers"][1]
    assert suffix["norm"] is model.params["norm"]
    assert ("lm_head" in suffix) == ("lm_head" in model.params)


def test_forward_from_layer_is_differentiable(jax_params):
    """The suffix runs under autograd: the gradient of a last-position
    logit reaches the hidden state at the splice, and not its pad rows."""
    _, model = _pair(jax_params, True)
    batch = _batch(True)
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 24, 64)).astype(np.float32)).requires_grad_()
    logits = model.forward_from_layer(h, "layers.0", batch)
    (grad,) = torch.autograd.grad(logits[:, 0, 7].sum(), h)
    assert grad[:, -1].abs().sum() > 0
    assert not grad[1, :5].any() and not grad[2, :17].any()


def test_last_attended_either_padding_side():
    mask = torch.tensor([[1, 1, 1, 0], [0, 1, 1, 1], [1, 1, 1, 1]])
    assert last_attended(mask).tolist() == [2, 3, 3]


def test_convert_round_trip_carries_lm_head(jax_params):
    params, tied = jax_params
    port = llama_params_from_jax(params, device="cpu")
    assert ("lm_head" in port) == (not tied)
    back = llama_params_to_jax(port)
    assert set(back) == set(params)
    if not tied:
        assert port["lm_head"].shape == (128, 64)
        np.testing.assert_array_equal(back["lm_head"], np.asarray(params["lm_head"]))


def test_init_llama_params_grows_lm_head():
    gen = torch.Generator().manual_seed(0)
    untied = init_llama_params(LlamaConfig(**TINY), gen, torch.device("cpu"))
    tied = init_llama_params(LlamaConfig(**TINY, tie_word_embeddings=True), gen, torch.device("cpu"))
    assert untied["lm_head"].shape == (128, 64) and "lm_head" not in tied


def test_prepare_inputs_matches_jax(jax_params):
    jmodel, model = _pair(jax_params, False)
    rows = [[5, 6, 7], [8, 9], [1, 2, 3]]
    ref, got = jmodel.prepare_inputs(prompt_ids=rows), model.prepare_inputs(prompt_ids=rows)
    assert set(got) == set(ref) == {"input_ids", "attention_mask"}
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(pad_text_rows([[1, 2], [3, 4]])["input_ids"],
                                  jax_pad_text_rows([[1, 2], [3, 4]])["input_ids"])
    assert "attention_mask" not in pad_text_rows([[1, 2], [3, 4]])
    with pytest.raises(ValueError):
        model.prepare_inputs(images=[object()], prompt_ids=rows)


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("torch_llama_suffix_ckpt")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(**TINY, max_position_embeddings=256)) \
        .save_pretrained(d, safe_serialization=True)
    return str(d)


def test_hf_checkpoint_logits_match_jax(llama_dir):
    """Both packages load the untied LM head of one HF checkpoint."""
    jparams, jcfg = jax_load_llama(llama_dir, dtype=jnp.float32)
    params, cfg = load_llama(llama_dir, dtype=torch.float32, device="cpu")
    assert "lm_head" in params
    batch = _batch(False)
    ref = np.asarray(JaxLlamaModel(jparams, dataclasses.replace(jcfg, flash_attention=True)).forward(batch)["logits"])
    got = LlamaModel(params, dataclasses.replace(cfg, flash_attention=True)).forward(batch)["logits"]
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
