"""The port's CLIP tower (multimodal_sae_tpu_torch/models/clip_vit.py)
against the JAX package's, on weights drawn with numpy and carried by
`convert.py`, and pixels drawn with numpy.

Tolerances: at fp32 both sides run the same ops in the same dtypes and
differ only in matmul summation order, so every output is within 1e-5
(absolute, on outputs of order 1; the tower has three layers).  At bf16
each side rounds its intermediates to bf16 (unit roundoff 2^-8), but XLA
may keep a fused chain of elementwise ops in fp32 where PyTorch rounds each
op, so single elements can differ by a few bf16 steps: held to a max
difference of 3% of max |JAX| and a relative L2 of 1.5e-2 (two to three
times what these seeds give).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models import clip_vit as jclip
from multimodal_sae_tpu_torch.convert import clip_params_from_jax, clip_params_to_jax, tensor_from_numpy
from multimodal_sae_tpu_torch.models import clip_vit as clip

from torch_llava_tiny import VISION, hf_config, numpy_state_dict

BF16_MAX_REL = 3e-2
BF16_L2_REL = 1.5e-2


def _tower(hidden_act="quick_gelu", seed=0):
    """(JAX params, port params, JAX cfg, port cfg) of the tiny tower."""
    hf_cfg = hf_config(hidden_act=hidden_act)
    sd = numpy_state_dict(hf_cfg, seed)
    vis = hf_cfg.vision_config.to_dict()
    jcfg, cfg = jclip.ClipVisionConfig.from_hf(vis), clip.ClipVisionConfig.from_hf(vis)
    jparams = jclip.clip_params_from_state_dict(sd, jcfg, dtype=jnp.float32, prefix="model.vision_tower.vision_model.")
    return jparams, clip_params_from_jax(jparams, device="cpu"), jcfg, cfg


def _pixels(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 3, VISION["image_size"], VISION["image_size"])).astype(np.float32)


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.astype(dtype) if hasattr(tree, "astype") else tree.to(dtype)


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("feature_layer", [-2, -1, 0])
def test_tower_matches_jax_at_fp32(hidden_act, feature_layer):
    jparams, params, jcfg, cfg = _tower(hidden_act)
    pv = _pixels()
    ref = jclip.clip_vision_forward(jparams, jcfg, jnp.asarray(pv), feature_layer=feature_layer)
    got = clip.clip_vision_forward(params, cfg, torch.from_numpy(pv), feature_layer=feature_layer)
    assert got.dtype == torch.float32 and got.shape == ref["features"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref["features"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_tower_matches_jax_at_bf16(hidden_act):
    jparams, params, jcfg, cfg = _tower(hidden_act, seed=2)
    jparams = _cast_tree(jparams, jnp.bfloat16)
    params = _cast_tree(params, torch.bfloat16)
    pv = _pixels(seed=3)  # fp32 pixels: both sides cast them to the tower's dtype
    ref = np.asarray(jclip.clip_vision_forward(jparams, jcfg, jnp.asarray(pv))["features"]).astype(np.float32)
    got = clip.clip_vision_forward(params, cfg, torch.from_numpy(pv))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= BF16_MAX_REL * np.abs(ref).max()
    assert np.linalg.norm(got - ref) <= BF16_L2_REL * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_activations_match_jax(dtype):
    """The elementwise pieces alone, eager on both sides, constants rounded
    to the dtype as JAX rounds them: fp32 within 1e-6; bf16 within 2^-5
    (1 + |x|), four bf16 steps at |x| < 2, since XLA's rsqrt and logistic
    round differently from PyTorch's by a step and layer norm multiplies
    that on."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 48)) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, w, b))
    tx, tw, tb = (tensor_from_numpy(np.asarray(a), "cpu") for a in (jx, jw, jb))
    tol = dict(rtol=2.0**-5, atol=2.0**-5) if dtype == "bfloat16" else dict(rtol=0, atol=1e-6)
    pairs = [
        (jclip.layer_norm(jx, jw, jb, 1e-5), clip.layer_norm(tx, tw, tb, 1e-5)),
        (jclip.quick_gelu(jx), clip.quick_gelu(tx)),
        (jclip._activation("gelu")(jx), clip._activation("gelu")(tx)),
        (jclip._activation("gelu_new")(jx), clip._activation("gelu_new")(tx)),
    ]
    for ref, got in pairs:
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32), **tol)


def test_patchify_matches_jax_exactly():
    pv = _pixels(n=2)
    ref = np.asarray(jclip._patchify(jnp.asarray(pv), 16))
    np.testing.assert_array_equal(clip._patchify(torch.from_numpy(pv), 16).numpy(), ref)


def test_state_dict_loader_and_convert_agree_with_jax():
    """The port's `clip_params_from_state_dict` equals the JAX loader's tree
    carried by `clip_params_from_jax`, and `clip_params_to_jax` inverts it."""
    hf_cfg = hf_config()
    sd = numpy_state_dict(hf_cfg, 5)
    prefix = "model.vision_tower.vision_model."
    vis = hf_cfg.vision_config.to_dict()
    cfg = clip.ClipVisionConfig.from_hf(vis)
    jparams = jclip.clip_params_from_state_dict(sd, jclip.ClipVisionConfig.from_hf(vis), dtype=jnp.float32, prefix=prefix)
    got = clip.clip_params_from_state_dict(sd, cfg, torch.device("cpu"), prefix=prefix)
    carried = clip_params_from_jax(jparams, device="cpu")
    assert got.keys() == carried.keys() and len(got["layers"]) == VISION["num_hidden_layers"]
    for key in got:
        if key != "layers":
            assert torch.equal(got[key], carried[key]), key
    for a, b in zip(got["layers"], carried["layers"]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    back = clip_params_to_jax(got)
    for key in jparams:
        if key != "layers":
            np.testing.assert_array_equal(back[key], np.asarray(jparams[key]))
    for a, b in zip(back["layers"], jparams["layers"]):
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_unported_and_unknown_options_raise():
    _, params, _, cfg = _tower()
    pv = torch.from_numpy(_pixels(n=1))
    import dataclasses

    with pytest.raises(NotImplementedError, match="ROADMAP.md §1, int8"):
        clip.clip_vision_forward(params, dataclasses.replace(cfg, int8_matmul=True), pv)
    with pytest.raises(NotImplementedError, match="silu"):
        clip.clip_vision_forward(params, dataclasses.replace(cfg, hidden_act="silu"), pv)


def test_random_init_has_the_loader_tree():
    """`init_clip_params` builds the tree the loader builds, at the widths."""
    _, params, _, cfg = _tower()
    init = clip.init_clip_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"), torch.bfloat16)
    assert init.keys() == params.keys()
    for key in init:
        if key != "layers":
            assert init[key].shape == params[key].shape and init[key].dtype == torch.bfloat16
    for a, b in zip(init["layers"], params["layers"]):
        assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
