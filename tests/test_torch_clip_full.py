"""The port's full CLIP (`models/clip_full.py`) against the JAX package's,
on one HF-layout state dict drawn with numpy (a tiny CLIPModel: vision 2 x
48 at 32 px, patch 16; text 2 x 40, 16 positions; projection 32), read by
both packages' `clip_model_params_from_state_dict`.

fp32 on both sides, products summed in other orders: TOL rtol 1e-4, atol
1e-5 on embeddings, pooled text states and scores (scores are on a 0-100
scale).  `preprocess_clip_image` is the same numpy and PIL code on both
sides: bit-equal."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models import clip_full as jax_clip
from multimodal_sae_tpu.models.clip_vit import ClipVisionConfig as JaxClipVisionConfig
from multimodal_sae_tpu_torch.models import clip_full
from multimodal_sae_tpu_torch.models.clip_vit import ClipVisionConfig

TOL = dict(rtol=1e-4, atol=1e-5)
VISION = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
              image_size=32, patch_size=16, projection_dim=32)
TEXT = dict(vocab_size=99, hidden_size=40, intermediate_size=80, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=16, projection_dim=32, eos_token_id=98)


def _state_dict(seed=0):
    """HF CLIPModel keys and shapes, values from numpy (norm weights near 1)."""
    rng = np.random.default_rng(seed)
    V, T = VISION, TEXT
    D, I, P = V["hidden_size"], V["intermediate_size"], V["projection_dim"]
    Dt, It = T["hidden_size"], T["intermediate_size"]
    n_pos = (V["image_size"] // V["patch_size"]) ** 2 + 1
    sd = {}

    def put(key, shape, scale=None, center=0.0):
        scale = scale if scale is not None else (shape[-1] ** -0.5 if len(shape) > 1 else 0.1)
        sd[key] = (center + scale * rng.normal(size=shape)).astype(np.float32)

    def layers(prefix, n, d, i):
        for layer in range(n):
            p = f"{prefix}encoder.layers.{layer}."
            for norm in ("layer_norm1", "layer_norm2"):
                put(p + norm + ".weight", (d,), 0.1, 1.0)
                put(p + norm + ".bias", (d,))
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put(p + f"self_attn.{proj}.weight", (d, d))
                put(p + f"self_attn.{proj}.bias", (d,))
            put(p + "mlp.fc1.weight", (i, d))
            put(p + "mlp.fc1.bias", (i,))
            put(p + "mlp.fc2.weight", (d, i))
            put(p + "mlp.fc2.bias", (d,))

    v = "vision_model."
    put(v + "embeddings.class_embedding", (D,), 0.02)
    put(v + "embeddings.patch_embedding.weight", (D, 3, V["patch_size"], V["patch_size"]), 0.05)
    put(v + "embeddings.position_embedding.weight", (n_pos, D), 0.02)
    for norm in ("pre_layrnorm", "post_layernorm"):
        put(v + norm + ".weight", (D,), 0.1, 1.0)
        put(v + norm + ".bias", (D,))
    layers(v, V["num_hidden_layers"], D, I)
    t = "text_model."
    put(t + "embeddings.token_embedding.weight", (T["vocab_size"], Dt), 0.02)
    put(t + "embeddings.position_embedding.weight", (T["max_position_embeddings"], Dt), 0.02)
    put(t + "final_layer_norm.weight", (Dt,), 0.1, 1.0)
    put(t + "final_layer_norm.bias", (Dt,))
    layers(t, T["num_hidden_layers"], Dt, It)
    put("visual_projection.weight", (P, D))
    put("text_projection.weight", (P, Dt))
    return sd


@pytest.fixture(scope="module", params=[98, 2], ids=["eos", "legacy-argmax"])
def both(request):
    sd = _state_dict()
    text = {**TEXT, "eos_token_id": request.param}
    jv, jt = JaxClipVisionConfig.from_hf(VISION), jax_clip.ClipTextConfig.from_hf(text)
    v, t = ClipVisionConfig.from_hf(VISION), clip_full.ClipTextConfig.from_hf(text)
    jparams = jax_clip.clip_model_params_from_state_dict(sd, jv, jt)
    params = clip_full.clip_model_params_from_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, v, t, "cpu")
    return (jparams, jv, jt), (params, v, t)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    pv = rng.normal(size=(3, 3, 32, 32)).astype(np.float32)
    # EOS (98, the highest id) once a row, ids after it are pads; row 2 has
    # a second 98 late, so "first eos" and "argmax" both pick the first.
    ids = np.array([[1, 5, 9, 98, 0, 0], [2, 7, 98, 3, 3, 3], [4, 98, 6, 98, 8, 1]])
    return pv, ids


def test_params_from_a_state_dict_match_jax(both):
    (jparams, _, _), (params, _, _) = both
    np.testing.assert_array_equal(params["visual_projection"].numpy().T, np.asarray(jparams["visual_projection"]))
    np.testing.assert_array_equal(params["text_projection"].numpy().T, np.asarray(jparams["text_projection"]))
    jl, pl = jparams["text"]["layers"], params["text"]["layers"]
    assert len(pl) == len(jl) == 2
    for jlayer, player in zip(jl, pl):
        assert set(player) == set(jlayer)
        for name, a in player.items():
            want = np.asarray(jlayer[name])
            np.testing.assert_array_equal(a.numpy().T if a.ndim == 2 else a.numpy(), want, err_msg=name)
    for name in ("token_embedding", "position_embedding", "final_layer_norm", "final_layer_norm_bias"):
        np.testing.assert_array_equal(params["text"][name].numpy(), np.asarray(jparams["text"][name]))


def test_text_forward_matches_jax(both):
    (jparams, _, jt), (params, _, t) = both
    _, ids = _inputs()
    want = np.asarray(jax_clip.clip_text_forward(jparams["text"], jt, jnp.asarray(ids)))
    got = clip_full.clip_text_forward(params["text"], t, torch.as_tensor(ids))
    assert got.shape == (3, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_embeddings_and_scores_match_jax(both):
    (jparams, jv, jt), (params, v, t) = both
    pv, ids = _inputs()
    img = clip_full.clip_embed_image(params, v, torch.from_numpy(pv))
    txt = clip_full.clip_embed_text(params, t, torch.as_tensor(ids))
    np.testing.assert_allclose(img.numpy(), np.asarray(jax_clip.clip_embed_image(jparams, jv, jnp.asarray(pv))), **TOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jax_clip.clip_embed_text(jparams, jt, jnp.asarray(ids))), **TOL)
    score = clip_full.clip_score(params, v, t, torch.from_numpy(pv), torch.as_tensor(ids))
    want = np.asarray(jax_clip.clip_score(jparams, jv, jt, jnp.asarray(pv), jnp.asarray(ids)))
    np.testing.assert_allclose(score.numpy(), want, **TOL)
    cos = torch.nn.functional.cosine_similarity(img.double(), txt.double(), dim=-1)
    np.testing.assert_allclose(score.numpy(), torch.clamp_min(100 * cos, 0).numpy(), **TOL)


def test_preprocess_is_bit_equal():
    from PIL import Image

    rng = np.random.default_rng(2)
    for shape in ((50, 70, 3), (90, 40, 3), (32, 32, 3)):
        img = Image.fromarray(rng.integers(0, 255, size=shape, dtype=np.uint8))
        got = clip_full.preprocess_clip_image(img, 32)
        want = jax_clip.preprocess_clip_image(img, 32)
        assert got.dtype == np.float32 and got.shape == (3, 32, 32)
        np.testing.assert_array_equal(got, want)


def test_clip_metric_on_a_checkpoint(tmp_path, monkeypatch):
    """The metric from a local checkpoint (config.json + safetensors), its
    tokenizer faked as the JAX tests fake it, equals `clip_score` on the
    preprocessed image and the padded ids; the JAX metric gives the same."""
    import json

    import transformers
    from PIL import Image

    from multimodal_sae_tpu_torch.utils.safetensors_io import save_file

    sd = _state_dict(seed=3)
    save_file(sd, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({"vision_config": VISION, "text_config": TEXT}))

    class Tok:
        def __call__(self, texts, padding, max_length, truncation, return_tensors):
            assert padding == "max_length" and truncation and return_tensors == "np"
            rows = [[(ord(c) % 90) + 1 for c in s][: max_length - 1] + [98] for s in texts]
            return {"input_ids": np.array([r + [0] * (max_length - len(r)) for r in rows])}

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda path: Tok())
    img = Image.fromarray(np.random.default_rng(4).integers(0, 255, size=(40, 48, 3), dtype=np.uint8))
    metric = clip_full.clip_metric(str(tmp_path), device="cpu")
    got = metric(img, "a red square")
    assert isinstance(got, float)
    v, t = ClipVisionConfig.from_hf(VISION), clip_full.ClipTextConfig.from_hf(TEXT)
    params = clip_full.clip_model_params_from_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, v, t, "cpu")
    ids = Tok()(["a red square"], "max_length", 16, True, "np")["input_ids"]
    pv = torch.from_numpy(clip_full.preprocess_clip_image(img, 32)[None])
    assert got == float(clip_full.clip_score(params, v, t, pv, torch.as_tensor(ids))[0])
    np.testing.assert_allclose(got, jax_clip.jax_clip_metric(str(tmp_path))(img, "a red square"), **TOL)


@pytest.mark.parametrize("entry", ["clip_embed_image", "clip_embed_text", "clip_score"])
def test_clip_entry_points_turn_tf32_off(both, monkeypatch, entry):
    (_, _, _), (params, v, t) = both
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    pv, ids = (torch.from_numpy(a) if a.dtype == np.float32 else torch.as_tensor(a) for a in _inputs())
    args = {"clip_embed_image": (params, v, pv), "clip_embed_text": (params, t, ids),
            "clip_score": (params, v, t, pv, ids)}[entry]
    getattr(clip_full, entry)(*args)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
