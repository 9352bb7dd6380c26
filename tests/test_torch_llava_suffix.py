"""The suffix forward of the port's LLaVA-NeXT subject
(`LlavaNextModel.suffix_params`, `forward_from_layer`) against the JAX
package's, on the tiny LLaVA of tests/torch_llava_tiny.py (numpy-drawn
fp32 weights carried by `convert.py`).

The hidden state fed to both sides is the port's capture of a prepared,
left-repacked batch (one row, and two rows of different anyres geometries),
so the two suffixes see the same input and the same mask.  Tolerance: the
logits within 1e-5 of the JAX values relative to their largest magnitude
(fp32 on both sides, summed in other orders over two text layers and the
vocabulary projection)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models.llava_next import _repack_left_padded as jax_repack_left_padded
from multimodal_sae_tpu_torch.models.llava_next import repack_left_padded

from torch_llava_tiny import BOS, IMG_TOKEN, images, models

FP32_REL = 1e-5
SIZES = {"one_row": [(50, 70)], "ragged": [(50, 70), (90, 40)]}
PROMPTS = [[BOS, IMG_TOKEN, 11, 12], [BOS, 13, IMG_TOKEN, 14, 15, 16]]


def _close(got: torch.Tensor, ref, rel=FP32_REL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module", params=[False, True], ids=["eager", "flash"])
def pair(request):
    return models(seed=0, flash=request.param)


def _batch(model, which):
    sizes = SIZES[which]
    prepared = model.prepare_inputs(images=images(sizes, seed=3), prompt_ids=PROMPTS[: len(sizes)])
    batch = repack_left_padded(prepared)
    ref = jax_repack_left_padded(prepared)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(batch[key], ref[key])
    return batch


@pytest.mark.parametrize("which", ["one_row", "ragged"])
@pytest.mark.parametrize("hook", ["model.layers.0", "layers.1"])
@pytest.mark.parametrize("last_logit_only", [True, False], ids=["last", "all"])
def test_forward_from_layer_matches_jax(pair, which, hook, last_logit_only):
    jmodel, model = pair
    batch = _batch(model, which)
    if which == "ragged":
        assert not np.asarray(batch["attention_mask"]).all()
        assert (np.asarray(batch["attention_mask"])[:, -1] == 1).all()
    hidden = model.capture(batch, [hook])[hook]
    got = model.forward_from_layer(hidden, hook, batch, last_logit_only=last_logit_only)
    ref = jmodel.forward_from_layer(jnp.asarray(hidden.numpy()), hook, batch, last_logit_only=last_logit_only)
    B, S = batch["input_ids"].shape
    assert got.shape == ((B, 1, 260) if last_logit_only else (B, S, 260))
    _close(got, ref)


@pytest.mark.parametrize("which", ["one_row", "ragged"])
def test_forward_from_the_hook_equals_the_full_forward(pair, which):
    """Resuming from a layer's captured output gives the full forward's
    last-token logits: the suffix holds no image step of its own."""
    _, model = pair
    batch = _batch(model, which)
    hook = "model.layers.0"
    with torch.no_grad():
        hidden = model.capture(batch, [hook])[hook]
        full = model.forward(batch)["logits"][:, -1:]
        got = model.forward_from_layer(hidden, hook, batch)
    _close(got, full.numpy())


def test_suffix_params_alias_the_live_weights(pair):
    jmodel, model = pair
    lm = model.params["language_model"]
    for hook, above in (("model.layers.0", 2), ("layers.1", 1), ("model.layers.2", 0)):
        suffix = model.suffix_params(hook)
        stacked = jmodel.suffix_params(hook)["layers"]  # the JAX layers are stacked on a leading axis
        assert len(suffix["layers"]) == above == stacked["down_proj"].shape[0]
        for got, want in zip(suffix["layers"], lm["layers"][3 - above:]):
            assert got.keys() == want.keys()
            assert all(got[name].data_ptr() == want[name].data_ptr() for name in want)
        for name in ("embed_tokens", "norm", "lm_head"):
            assert suffix[name].data_ptr() == lm[name].data_ptr()
        assert "vision_tower" not in suffix and "projector" not in suffix


def test_forward_from_layer_is_differentiable(pair):
    _, model = pair
    batch = _batch(model, "ragged")
    hidden = model.capture(batch, ["model.layers.1"])["model.layers.1"].clone().requires_grad_()
    logits = model.forward_from_layer(hidden, "model.layers.1", batch)
    (grad,) = torch.autograd.grad(logits[:, 0, 3].sum(), hidden)
    assert grad.shape == hidden.shape and torch.isfinite(grad).all()
    am = np.asarray(batch["attention_mask"]).astype(bool)
    assert not grad[torch.from_numpy(~am)].any()  # pad positions get no gradient
    assert grad[torch.from_numpy(am)].abs().sum() > 0


def test_forward_from_layer_turns_tf32_off(pair):
    _, model = pair
    batch = _batch(model, "one_row")
    hidden = model.capture(batch, ["layers.1"])["layers.1"]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    model.forward_from_layer(hidden, "layers.1", batch)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
