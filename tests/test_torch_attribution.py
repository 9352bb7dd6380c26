"""Attribution patching in the PyTorch port against the JAX package, on the
tiny subject of tests/test_torch_llama.py (3 layers, hidden 64, 4 heads,
2 kv heads, vocab 128, fp32) and an SAE of 64 latents at k = 4, weights
carried across by `convert.py`, inputs numpy-seeded.

The port's `fast_attribution_maps` against the JAX package's, with flash
attention on and off, over features inside and outside the clean top-k,
with k == width, and on a left-padded 2-row batch; the port's fast path
against its general path through `Attribution` and the adapters of
tests/test_launch_integration.py; the ragged tail and the halving on
running out of device memory.  Tolerance rtol 1e-4, atol 1e-6 in fp32, as
tests/test_launch_integration.py holds the JAX fast path to its general
one.  On the left-padded batch, both packages' attention backward sees
dO == 0 on every row without a valid key, the condition under which the
port's K3 backward agrees with jax's reference."""

import json
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.patching.attribution import fast_attribution_maps as jax_fast_attribution_maps
from multimodal_sae_tpu.features.patching.utils import get_logit_diff as jax_get_logit_diff
from multimodal_sae_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlamaModel
from multimodal_sae_tpu.models.llama import init_llama_params as jax_init_llama_params
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, sae_params_from_jax
from multimodal_sae_tpu_torch.features.patching import attribution as A
from multimodal_sae_tpu_torch.features.patching import (
    Attribution,
    fast_attribution_maps,
    general_attribution_maps,
    get_logit_diff,
)
from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel, llama_forward
from multimodal_sae_tpu_torch.ops import flash_attention as fa
from multimodal_sae_tpu_torch.sae import Sae

TOL = dict(rtol=1e-4, atol=1e-6)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)
HOOK = "layers.1"
ANSWERS = np.array([[3, 4], [5, 6]])


@pytest.fixture(scope="module")
def jax_llama():
    return jax_init_llama_params(jax.random.PRNGKey(0), JaxLlamaConfig(**TINY), dtype=jnp.float32)


def _sae_pair(num_latents=64, k=4, seed=1):
    jsae = JaxSae(64, JaxSaeConfig(num_latents=num_latents, k=k), key=jax.random.PRNGKey(seed))
    params = sae_params_from_jax({name: np.asarray(a) for name, a in jsae.params.items()}, device="cpu")
    return jsae, Sae(64, SaeConfig(num_latents=num_latents, k=k), params=params)


def _models(jax_llama, flash):
    return (JaxLlamaModel(jax_llama, JaxLlamaConfig(**TINY, flash_attention=flash)),
            LlamaModel(llama_params_from_jax(jax_llama, device="cpu"), LlamaConfig(**TINY, flash_attention=flash)))


def _batch(padded, rows=2, S=20):
    ids = np.random.default_rng(0).integers(1, 128, size=(rows, S))
    if not padded:
        return {"input_ids": ids}
    mask = np.ones_like(ids)
    mask[1, :6] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _both(jmodel, model, jsae, sae, batch, indices, feature_batch):
    answers = ANSWERS[: len(batch["input_ids"])]
    ref = jax_fast_attribution_maps(jmodel, HOOK, jsae, batch,
                                    partial(jax_get_logit_diff, answer_token_indices=jnp.asarray(answers)),
                                    indices, feature_batch=feature_batch, progress=False)[HOOK]
    got = fast_attribution_maps(model, HOOK, sae, batch,
                                partial(get_logit_diff, answer_token_indices=torch.as_tensor(answers)),
                                indices, feature_batch=feature_batch, progress=False)[HOOK]
    return [np.asarray(r) for r in ref], got


def _in_topk(model, sae, batch):
    h = model.capture(batch, [HOOK])[HOOK]
    return sorted({int(i) for i in sae.encode(h.reshape(-1, 64)).top_indices.reshape(-1)})


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("padded", [False, True], ids=["rectangular", "left-padded"])
def test_fast_attribution_matches_jax(jax_llama, flash, padded):
    """Features inside the clean top-k (the ablation changes the selection)
    and outside it (saliency exactly 0 on both sides), over a ragged last
    chunk; on the padded batch the pad positions' saliency is exactly 0."""
    jmodel, model = _models(jax_llama, flash)
    jsae, sae = _sae_pair()
    batch = _batch(padded)
    inside = _in_topk(model, sae, batch)
    outside = [f for f in range(64) if f not in inside]
    indices = inside[:4] + outside[:3]
    ref, got = _both(jmodel, model, jsae, sae, batch, indices, feature_batch=3)
    assert len(got) == len(indices)
    for f, r, g in zip(indices, ref, got):
        assert g.shape == (2, 20) and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, err_msg=f"feature {f}", **TOL)
    for g in got[4:]:
        assert not g.any()
    assert any(g.any() for g in got[:4])
    if padded:
        for g in got:
            assert not g[1, :6].any()


def test_degenerate_k_equals_width(jax_llama):
    """k == num_latents: the ablated feature stays selected at value 0 in
    the reference; the port's re-selection decodes the dropped slot as 0."""
    jmodel, model = _models(jax_llama, True)
    jsae, sae = _sae_pair(num_latents=16, k=16, seed=2)
    ref, got = _both(jmodel, model, jsae, sae, _batch(False), [0, 7, 15], feature_batch=2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)


def test_pad_rows_get_zero_output_gradient_on_both_sides(jax_llama, monkeypatch):
    """On a left-padded batch, every attention backward of the attribution
    path receives dO == 0 on the rows without a valid key, in the JAX
    package (jax's `mha_reference`, its S padded to 128) and in the port."""
    import jax.experimental.pallas.ops.tpu.flash_attention as jax_fa

    seen_jax, seen_port = [], []
    reference = jax_fa.mha_reference

    @jax.custom_vjp
    def tap(o):
        return o

    def tap_bwd(_, g):
        jax.debug.callback(lambda x: seen_jax.append(np.asarray(x)), g)
        return (g,)

    tap.defvjp(lambda o: (o, None), tap_bwd)
    monkeypatch.setattr(jax_fa, "mha_reference", lambda *a, **kw: tap(reference(*a, **kw)))
    plain_bwd = fa.flash_attention_bwd_plain

    def record(q, k, v, pad_mask, o, lse, do, scale):
        seen_port.append(do.detach().numpy().copy())
        return plain_bwd(q, k, v, pad_mask, o, lse, do, scale)

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", record)
    jmodel, model = _models(jax_llama, True)
    jsae, sae = _sae_pair()
    batch = _batch(True)
    inside = _in_topk(model, sae, batch)
    ref, got = _both(jmodel, model, jsae, sae, batch, inside[:2], feature_batch=2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)
    # One suffix layer (layer 2) and one chunk: one backward in the port;
    # the JAX side may call back once per vmapped feature.
    assert len(seen_jax) >= 1 and len(seen_port) == 1
    for do in seen_jax + seen_port:
        rows = do.reshape(-1, 2, *do.shape[-3:])  # (features, B, H, S, hd)
        assert not rows[:, 1, :, :6].any()
        assert rows[:, :, :, 6:20].any()


class Tok:
    def __call__(self, text, **kw):
        return {"input_ids": [1] + [2 + ord(c) % 50 for c in text]}

    def convert_tokens_to_ids(self, tok):
        return 2 + ord(tok[0]) % 50


def test_fast_path_matches_general_path(jax_llama, tmp_path):
    """`Attribution` on the adapters of tests/test_launch_integration.py:
    the fast path (a model with `forward_from_layer`) against the general
    full spliced forward, inside and outside the top-k, and with
    k == width."""
    from PIL import Image

    base = LlamaModel(llama_params_from_jax(jax_llama, device="cpu"), LlamaConfig(**TINY))

    class General:
        """forward-protocol adapter without forward_from_layer."""

        def prepare_inputs(self, images=None, prompt_ids=None):
            n = max(len(r) for r in prompt_ids)
            ids = np.zeros((len(prompt_ids), n), dtype=np.int64)
            for i, r in enumerate(prompt_ids):
                ids[i, : len(r)] = r
            return {"input_ids": ids}

        def forward(self, batch, capture=(), interventions=None, return_logits=True):
            return llama_forward(base.params, base.cfg, torch.as_tensor(batch["input_ids"]),
                                 capture=capture, interventions=interventions, return_logits=return_logits)

    class Fast(General):
        """Adds the fast-path surface."""

        def capture(self, batch, hookpoints):
            return base.capture(batch, hookpoints)

        def forward_from_layer(self, hidden, hookpoint, batch, **kw):
            return base.forward_from_layer(hidden, hookpoint, batch, **kw)

    img = tmp_path / "x.png"
    Image.new("RGB", (8, 8)).save(img)
    (tmp_path / "p.json").write_text(json.dumps(
        [{"prompt": "abqxyzw", "answer": "c", "baseline": "d", "image": str(img)}]))

    def build(model, feature_batch):
        return Attribution(model, Tok(), sae_path=str(tmp_path / "saes"), data_path=str(tmp_path / "p.json"),
                           selected_sae=HOOK, feature_batch=feature_batch, device="cpu")

    for num_latents, k in ((64, 4), (16, 16)):
        Sae(64, SaeConfig(num_latents=num_latents, k=k), seed=3, device="cpu").save_to_disk(tmp_path / "saes" / HOOK)
        fast = build(Fast(), 2)
        sae = fast.sae_dict[HOOK]
        assert sae.W_dec.shape == (num_latents, 64)
        inside = _in_topk(base, sae, fast.batch)
        indices = inside[:3] + [f for f in range(num_latents) if f not in inside][:2]
        general_out = build(General(), 2).get_attribution(indices=indices)[HOOK]
        fast_out = fast.get_attribution(indices=indices)[HOOK]
        assert len(fast_out) == len(general_out) == len(indices)
        for g, f in zip(general_out, fast_out):
            np.testing.assert_allclose(f, g, **TOL)


@pytest.mark.parametrize("entry", ["FastAttribution", "fast_attribution_maps", "Attribution"])
def test_entry_points_turn_tf32_off(jax_llama, tmp_path, monkeypatch, entry):
    """Each attribution entry point runs the fp32 prefix encode with TF32
    off, whatever the caller left set, as the cache path does."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = LlamaModel(llama_params_from_jax(jax_llama, device="cpu"), LlamaConfig(**TINY))
    _, sae = _sae_pair()
    batch = _batch(False)
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    if entry == "FastAttribution":
        A.FastAttribution(model, HOOK, sae, batch, metric)
    elif entry == "fast_attribution_maps":
        # The entry point itself, not only the step it builds.
        monkeypatch.setattr(A, "build_fast_attribution", lambda *a: lambda f: torch.zeros(len(f), 2, 20))
        fast_attribution_maps(model, HOOK, sae, batch, metric, [0], feature_batch=1, progress=False)
    else:
        from PIL import Image

        Image.new("RGB", (8, 8)).save(tmp_path / "x.png")
        (tmp_path / "p.json").write_text(json.dumps(
            [{"prompt": "abq", "answer": "c", "baseline": "d", "image": str(tmp_path / "x.png")}]))
        sae.save_to_disk(tmp_path / "saes" / HOOK)

        class Model:
            def prepare_inputs(self, images=None, prompt_ids=None):
                return {"input_ids": np.asarray(prompt_ids, dtype=np.int64)}

        Attribution(Model(), Tok(), sae_path=str(tmp_path / "saes"), data_path=str(tmp_path / "p.json"),
                    selected_sae=HOOK, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_general_path_on_a_padded_batch(jax_llama):
    """The general path with one splice equals the fast path on a
    left-padded batch.  Two splices at once differentiate the upper splice's
    decode, a path not yet held against the JAX package: refused."""
    model = LlamaModel(llama_params_from_jax(jax_llama, device="cpu"), LlamaConfig(**TINY, flash_attention=True))
    _, sae = _sae_pair()
    batch = _batch(True)
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    with pytest.raises(NotImplementedError, match="several hookpoints"):
        general_attribution_maps(model, {"layers.0": sae, HOOK: sae}, batch, metric, [0], progress=False)
    one = general_attribution_maps(model, {HOOK: sae}, batch, metric, [0, 5], progress=False)[HOOK]
    fast = fast_attribution_maps(model, HOOK, sae, batch, metric, [0, 5], progress=False)[HOOK]
    for g, f in zip(one, fast):
        np.testing.assert_allclose(f, g, **TOL)


def test_ragged_tail_matches_one_chunk(jax_llama):
    """Chunks of 2 over 5 features (the tail padded and trimmed) give what
    one chunk of 5 gives."""
    _, model = _models(jax_llama, True)
    _, sae = _sae_pair()
    batch = _batch(False)
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(ANSWERS))
    indices = _in_topk(model, sae, batch)[:5]
    chunked = fast_attribution_maps(model, HOOK, sae, batch, metric, indices, feature_batch=2, progress=False)[HOOK]
    whole = fast_attribution_maps(model, HOOK, sae, batch, metric, indices, feature_batch=5, progress=False)[HOOK]
    assert len(chunked) == 5
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a, b, **TOL)


def test_out_of_memory_halves_the_feature_batch(monkeypatch):
    """On torch.cuda.OutOfMemoryError the chunk is retried at half the
    width, down to 1, and the ragged tail is padded and trimmed."""
    B, S = 1, 3
    widths_seen = []

    def fake_build(model, hook, sae, batch, metric):
        def step(feats):
            widths_seen.append(len(feats))
            if len(feats) > 2:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return torch.stack([torch.full((B, S), float(f)) for f in feats.tolist()])

        return step

    monkeypatch.setattr(A, "build_fast_attribution", fake_build)
    out = fast_attribution_maps(None, "layers.0", None, {"input_ids": np.zeros((B, S))}, None,
                                indices=[0, 1, 2, 3, 4], feature_batch=8, progress=False)
    assert widths_seen == [8, 4, 2, 2, 2]
    sal = out["layers.0"]
    assert [float(s[0, 0]) for s in sal] == [0.0, 1.0, 2.0, 3.0, 4.0]

    def always_oom(model, hook, sae, batch, metric):
        def step(feats):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        return step

    monkeypatch.setattr(A, "build_fast_attribution", always_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        fast_attribution_maps(None, "layers.0", None, {}, None, indices=[0], feature_batch=4, progress=False)
