"""The port's general attribution path over several hookpoints against the
JAX package's general branch of `Attribution.get_attribution`.

Tiny fp32 LLaMA (3 layers, hidden 64) with SAEs spliced at `layers.0` and
`layers.1`: the gradient at the lower splice runs back through the upper
splice's decode, top-k and encoder product.  The JAX side is its own
`Attribution` built without `__init__` (which opens images), so its
`feature_batch` vmap with the ragged tail padded and trimmed is what runs;
the port runs one feature at a time.  Weights from the JAX package carried
by `convert.py`; inputs numpy-seeded.  TOL: rtol 1e-4, atol 1e-6, the
tolerance tests/test_torch_attribution.py holds the fast path to."""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.patching.attribution import Attribution as JaxAttribution
from multimodal_sae_tpu.features.patching.utils import get_logit_diff as jax_get_logit_diff
from multimodal_sae_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlamaModel
from multimodal_sae_tpu.models.llama import init_llama_params as jax_init_llama_params
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, sae_params_from_jax
from multimodal_sae_tpu_torch.features.patching import Attribution, general_attribution_maps, get_logit_diff
from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
from multimodal_sae_tpu_torch.ops import gather_rows
from multimodal_sae_tpu_torch.ops.topk import top_k
from multimodal_sae_tpu_torch.sae import Sae

TOL = dict(rtol=1e-4, atol=1e-6)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)
HOOKS = ("layers.0", "layers.1")
ANSWERS = np.array([[3, 4], [5, 6]])


@pytest.fixture(scope="module")
def jax_llama():
    return jax_init_llama_params(jax.random.PRNGKey(0), JaxLlamaConfig(**TINY), dtype=jnp.float32)


def _sae_pairs(num_latents=64, k=4):
    jsaes, saes = {}, {}
    for seed, hook in enumerate(HOOKS, start=1):
        jsae = JaxSae(64, JaxSaeConfig(num_latents=num_latents, k=k), key=jax.random.PRNGKey(seed))
        params = sae_params_from_jax({n: np.asarray(a) for n, a in jsae.params.items()}, device="cpu")
        jsaes[hook], saes[hook] = jsae, Sae(64, SaeConfig(num_latents=num_latents, k=k), params=params)
    return jsaes, saes


def _batch(padded):
    ids = np.random.default_rng(0).integers(1, 128, size=(2, 20))
    if not padded:
        return {"input_ids": ids}
    mask = np.ones_like(ids)
    mask[1, :6] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _jax_general(jax_llama, jsaes, batch, indices, feature_batch, flash):
    """The JAX package's general branch, as `get_attribution` runs it."""
    att = object.__new__(JaxAttribution)
    att.model = JaxLlamaModel(jax_llama, JaxLlamaConfig(**TINY, flash_attention=flash))
    att.sae_dict = jsaes
    att.data = [None] * len(batch["input_ids"])
    att.batch = batch
    att.feature_batch = feature_batch
    att.metric = partial(jax_get_logit_diff, answer_token_indices=jnp.asarray(ANSWERS))
    out = att.get_attribution(indices=indices)
    return {name: [np.asarray(a) for a in maps] for name, maps in out.items()}


def _port_model(jax_llama, flash):
    return LlamaModel(llama_params_from_jax(jax_llama, device="cpu"), LlamaConfig(**TINY, flash_attention=flash))


def _inside_both(model, saes, batch):
    """Features in some token's clean top-k at both hooks."""
    from multimodal_sae_tpu_torch.features.patching import spliced_forward_with_delta

    zeros = {h: torch.zeros(2, 20, 64) for h in HOOKS}
    with torch.no_grad():
        _, clean = spliced_forward_with_delta(model, batch, saes, zeros)
        # the upper SAE reads the lower splice's output through layer 1
        h = model.forward(batch, capture=HOOKS, interventions={
            HOOKS[0]: lambda x: clean[HOOKS[0]]})["captured"]
    sets = [set(saes[n].encode(h[n].reshape(-1, 64)).top_indices.reshape(-1).tolist()) for n in HOOKS]
    return sorted(sets[0] & sets[1]), sets[0] | sets[1]


def _assert_maps_equal(got, ref, indices):
    assert set(got) == set(ref) == set(HOOKS)
    for name in HOOKS:
        assert len(got[name]) == len(ref[name]) == len(indices)
        for f, g, r in zip(indices, got[name], ref[name]):
            assert g.shape == (2, 20) and np.isfinite(g).all()
            np.testing.assert_allclose(g, r, err_msg=f"{name} feature {f}", **TOL)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("feature_batch", [1, 3])
def test_two_hookpoints_match_jax(jax_llama, feature_batch, flash):
    """Five features (a ragged tail at feature_batch 3): four inside the
    top-k at both hooks, one outside every top-k, whose saliency is exactly
    zero at both hooks on both sides."""
    model = _port_model(jax_llama, flash)
    jsaes, saes = _sae_pairs()
    batch = _batch(False)
    both, either = _inside_both(model, saes, batch)
    outside = [f for f in range(64) if f not in either]
    assert len(both) >= 4 and outside
    indices = both[:4] + outside[:1]
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    before = gather_rows.dvals_launches
    got = general_attribution_maps(model, saes, batch, metric, indices, progress=False)
    assert gather_rows.dvals_launches == before  # the CPU takes the plain version
    ref = _jax_general(jax_llama, jsaes, batch, indices, feature_batch, flash)
    _assert_maps_equal(got, ref, indices)
    for name in HOOKS:
        assert not got[name][4].any()
        assert all(g.any() for g in got[name][:4])


def test_gradient_reaches_the_lower_splice_through_the_upper_one(jax_llama):
    """At the lower hook the saliency differs from what a splice at that
    hook alone gives: the upper splice's backward is on the path."""
    model = _port_model(jax_llama, True)
    _, saes = _sae_pairs()
    batch = _batch(False)
    both, _ = _inside_both(model, saes, batch)
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    two = general_attribution_maps(model, saes, batch, metric, both[:2], progress=False)[HOOKS[0]]
    one = general_attribution_maps(model, {HOOKS[0]: saes[HOOKS[0]]}, batch, metric, both[:2], progress=False)
    for a, b in zip(two, one[HOOKS[0]]):
        assert not np.allclose(a, b, **TOL)


def test_wide_sae_two_hookpoints_match_jax(jax_llama):
    """At 32,768 latents the top-k takes the block-max filter (K1's plain
    version here) on both sides; its gathers pass the gradient into the
    selected values."""
    model = _port_model(jax_llama, True)
    jsaes, saes = _sae_pairs(num_latents=32768, k=8)
    batch = _batch(True)
    both, _ = _inside_both(model, saes, batch)
    indices = both[:2] + [32767]
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    got = general_attribution_maps(model, saes, batch, metric, indices, progress=False)
    ref = _jax_general(jax_llama, jsaes, batch, indices, 2, True)
    _assert_maps_equal(got, ref, indices)


@pytest.mark.parametrize("width", [64, 32768])
def test_top_k_passes_the_gradient_into_the_selected_values(width):
    rng = np.random.default_rng(4)
    x = torch.tensor(np.maximum(rng.normal(size=(6, width)), 0).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32))
    vals, idx = top_k(x, 8, assume_finite=True)
    (grad,) = torch.autograd.grad((vals * w).sum(), x)
    want = torch.zeros_like(x).scatter_(1, idx.long(), w)
    assert torch.equal(grad, want)


class Tok:
    def __call__(self, text, **kw):
        return {"input_ids": [1] + [2 + ord(c) % 50 for c in text]}

    def convert_tokens_to_ids(self, tok):
        return 2 + ord(tok[0]) % 50


def test_attribution_takes_the_general_path_for_several_saes(jax_llama, tmp_path):
    """`Attribution.get_attribution` with both SAEs loaded from disk gives
    the general path's maps at both hooks."""
    import json

    from PIL import Image

    model = _port_model(jax_llama, True)
    _, saes = _sae_pairs()
    for hook, sae in saes.items():
        sae.save_to_disk(tmp_path / "saes" / hook)
    Image.new("RGB", (8, 8)).save(tmp_path / "x.png")
    (tmp_path / "p.json").write_text(json.dumps(
        [{"prompt": "abqxyzwvut", "answer": "c", "baseline": "d", "image": str(tmp_path / "x.png")}]))

    class Text:
        def prepare_inputs(self, images=None, prompt_ids=None):
            return model.prepare_inputs(prompt_ids=prompt_ids)

        def forward(self, batch, **kw):
            return model.forward(batch, **kw)

    att = Attribution(Text(), Tok(), sae_path=str(tmp_path / "saes"), data_path=str(tmp_path / "p.json"),
                      feature_batch=3, device="cpu")
    assert set(att.sae_dict) == set(HOOKS)
    got = att.get_attribution(indices=[0, 5, 9])
    want = general_attribution_maps(model, att.sae_dict, att.batch, att.metric, [0, 5, 9], progress=False)
    assert set(got) == set(HOOKS)
    for name in HOOKS:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


def test_general_path_turns_tf32_off(jax_llama, monkeypatch):
    """The general path encodes in fp32 with TF32 off whatever the caller
    left set, as the fast path and the cache path do."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _, saes = _sae_pairs()
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    general_attribution_maps(_port_model(jax_llama, True), saes, _batch(False), metric, [0], progress=False)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
