"""LLaMA capture in the PyTorch port against the JAX package's
`LlamaModel.capture`, on a tiny config built here (3 layers, hidden 64,
4 heads, 2 kv heads, fp32): weights from the JAX package's
`init_llama_params` carried across by `convert.py`, and a tiny HF checkpoint
read by both packages' `hf_loader`.  Tolerance atol 1e-4: fp32 on both
sides, matmuls and softmax summed in different orders over 1-3 layers."""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models.hf_loader import load_llama as jax_load_llama
from multimodal_sae_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlamaModel
from multimodal_sae_tpu.models.llama import init_llama_params as jax_init_llama_params
from multimodal_sae_tpu.models.llama import rope_cos_sin as jax_rope_cos_sin
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, llama_params_to_jax
from multimodal_sae_tpu_torch.models.hf_loader import load_llama
from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel, rope_cos_sin

transformers = pytest.importorskip("transformers")

TOL = dict(rtol=0, atol=1e-4)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_llama_params(jax.random.PRNGKey(0), JaxLlamaConfig(**TINY), dtype=jnp.float32)


def _pair(jax_params, flash, **cfg_kw):
    jmodel = JaxLlamaModel(jax_params, JaxLlamaConfig(**TINY, flash_attention=flash, **cfg_kw))
    model = LlamaModel(llama_params_from_jax(jax_params, device="cpu"),
                       LlamaConfig(**TINY, flash_attention=flash, **cfg_kw))
    return jmodel, model


def _batch(padded=False):
    ids = np.random.default_rng(0).integers(1, 128, size=(3, 40))
    if not padded:
        return {"input_ids": ids}
    mask = np.ones_like(ids)
    mask[1, :7] = 0
    mask[2, :25] = 0
    return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("padded", [False, True], ids=["rectangular", "left-padded"])
def test_capture_matches_jax(jax_params, flash, padded):
    """Captures at layers.1 (and layers.0) from the same weights.  Left
    padding: real positions are compared (a pad position's hidden state is
    never read, and the eager and flash masks treat pad rows differently)."""
    jmodel, model = _pair(jax_params, flash)
    batch = _batch(padded)
    hooks = ["layers.0", "layers.1"]
    ref = jmodel.capture(batch, hooks)
    got = model.capture(batch, hooks)
    assert set(got) == set(hooks)
    real = batch.get("attention_mask", np.ones_like(batch["input_ids"])).astype(bool)
    for hook in hooks:
        assert got[hook].dtype == torch.float32 and got[hook].shape == (3, 40, 64)
        np.testing.assert_allclose(got[hook].numpy()[real], np.asarray(ref[hook])[real], err_msg=hook, **TOL)


def test_convert_round_trip(jax_params):
    """JAX (in, out) -> port (out, in) -> JAX layout is the identity."""
    back = llama_params_to_jax(llama_params_from_jax(jax_params, device="cpu"))
    np.testing.assert_array_equal(back["embed_tokens"], np.asarray(jax_params["embed_tokens"]))
    for ref_layer, layer in zip(jax_params["layers"], back["layers"]):
        assert set(layer) == set(ref_layer)
        for name in layer:
            np.testing.assert_array_equal(layer[name], np.asarray(ref_layer[name]), err_msg=name)


def test_capture_stops_after_the_last_hookpoint(jax_params, monkeypatch):
    from multimodal_sae_tpu_torch.models import llama as port_llama

    _, model = _pair(jax_params, flash=False)
    calls = []
    real = port_llama.decoder_layer
    monkeypatch.setattr(port_llama, "decoder_layer", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    model.capture(_batch(), ["layers.1"])
    assert len(calls) == 2  # layers 0 and 1, not 2


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    """A tiny random LlamaForCausalLM saved as a local HF checkpoint, with
    fabricated tokenizer files so `load_subject_model` runs offline."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("torch_llama_ckpt")
    cfg = transformers.LlamaConfig(**TINY, max_position_embeddings=256)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({str(i): i for i in range(128)}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0").save_pretrained(d)
    return str(d)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_hf_loader_matches_jax(llama_dir, flash):
    """Both packages read one HF checkpoint through their own loader (the
    port through its own safetensors reader) and capture alike."""
    jparams, jcfg = jax_load_llama(llama_dir, dtype=jnp.float32)
    jmodel = JaxLlamaModel(jparams, dataclasses.replace(jcfg, flash_attention=flash))
    params, cfg = load_llama(llama_dir, dtype=torch.float32, device="cpu")
    model = LlamaModel(params, dataclasses.replace(cfg, flash_attention=flash))
    batch = _batch()
    ref = jmodel.capture(batch, ["layers.2"])["layers.2"]
    got = model.capture(batch, ["layers.2"])["layers.2"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_truncate_layers_leaves_the_capture_unchanged(llama_dir, flash):
    """`load_subject_model(truncate_layers=2)`: two layers resident, and the
    capture at layers.1 equals the full model's, and the JAX package's."""
    from multimodal_sae_tpu.launch.utils import load_subject_model as jax_load_subject
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model

    model, _, tok = load_subject_model(
        llama_dir, dtype=torch.float32, truncate_layers=2, flash_attention=flash, device="cpu"
    )
    full, _, _ = load_subject_model(llama_dir, dtype=torch.float32, flash_attention=flash, device="cpu")
    assert tok is not None
    assert len(model.params["layers"]) == 2 and model.hookpoint_names() == ["layers.0", "layers.1"]
    batch = _batch()
    got = model.capture(batch, ["layers.1"])["layers.1"]
    assert torch.equal(got, full.capture(batch, ["layers.1"])["layers.1"])
    jmodel, _, _ = jax_load_subject(llama_dir, dtype=jnp.float32, truncate_layers=2, flash_attention=flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.capture(batch, ["layers.1"])["layers.1"]), **TOL)
    with pytest.raises(ValueError):
        load_subject_model(llama_dir, truncate_layers=4, device="cpu")


def test_llama3_rope_scaling_matches_jax(llama_dir):
    scaling = {
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
    }
    pos = np.arange(300)[None, :]
    jc, js = jax_rope_cos_sin(jnp.asarray(pos), 128, 500000.0, scaling)
    c, s = rope_cos_sin(torch.from_numpy(pos), 128, 500000.0, scaling)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    with open(f"{llama_dir}/config.json") as f:
        hf = json.load(f)
    cfg = LlamaConfig.from_hf({**hf, "rope_scaling": {"rope_type": "llama3", **scaling}})
    assert cfg.rope_scaling_dict == scaling
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_hf({**hf, "rope_scaling": {"rope_type": "linear", "factor": 2.0}})
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_hf({**hf, "attention_bias": True})
