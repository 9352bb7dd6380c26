"""The PyTorch port's training forward against the JAX package's, on the
same parameters (carried by `convert.py`) and inputs drawn from a numpy
seed: `forward` at fast and slow, without `dead_mask`, with fewer dead
latents than k_aux (the threshold is -inf: the mask is the dead set) and
with more, with and without Multi-TopK.  Losses, `sae_out` and the gradients
of the trainer's loss (fvu + auxk / 32 + multi_topk_fvu / 8, through
`jax.value_and_grad` on the JAX side) within rtol 1e-5 (fp32 matmuls and
reductions summed in other orders); `fired` exactly equal.  Token 0 has
fewer than k positive pre-activations, so its k-th value is 0 and the fired
rule (selected and positive) matters.  The decoder renorm and the gradient
projection within 1e-6."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.sae.model import forward as jax_forward
from multimodal_sae_tpu.sae.model import remove_gradient_parallel_to_decoder_directions as jax_project
from multimodal_sae_tpu.sae.model import set_decoder_norm_to_unit_norm as jax_renorm
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.sae import (
    Sae,
    forward,
    remove_gradient_parallel_to_decoder_directions,
    set_decoder_norm_to_unit_norm,
)

D, L, K, N = 16, 256, 4, 24
RTOL = 1e-5
AUXK_ALPHA = 1 / 32


def _params(seed=0):
    rng = np.random.default_rng(seed)
    W_enc = (rng.standard_normal((D, L)) / D**0.5).astype(np.float32)
    W_dec = W_enc.T / np.linalg.norm(W_enc.T, axis=1, keepdims=True)
    b_enc = (rng.standard_normal(L) * 0.2 - 0.3).astype(np.float32)
    b_enc[:2] = 0.5  # the two latents positive at x = b_dec
    return {"W_enc": W_enc, "b_enc": b_enc, "W_dec": W_dec.astype(np.float32),
            "b_dec": (rng.standard_normal(D) * 0.1).astype(np.float32)}


def _x(params, seed=1):
    x = np.random.default_rng(seed).standard_normal((N, D)).astype(np.float32)
    x[0] = params["b_dec"]  # pre = relu(b_enc): two positives < k
    return x


def _dead(kind):
    if kind is None:
        return None
    dead = np.zeros(L, dtype=bool)
    dead[np.random.default_rng(2).choice(L, size=5 if kind == "few" else 100, replace=False)] = True
    return dead  # k_aux = D // 2 = 8


def _jax_run(params, x, cfg, dead, fast):
    def loss_fn(p):
        out = jax_forward(p, jnp.asarray(x), cfg, None if dead is None else jnp.asarray(dead), fast=fast)
        return out.fvu + AUXK_ALPHA * out.auxk_loss + out.multi_topk_fvu / 8, out

    (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)({k: jnp.asarray(v) for k, v in params.items()})
    return out, {k: np.asarray(v) for k, v in grads.items()}


def _torch_run(params, x, cfg, dead, fast):
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    out = forward(p, torch.from_numpy(x), cfg, None if dead is None else torch.from_numpy(dead), fast=fast)
    (out.fvu + AUXK_ALPHA * out.auxk_loss + out.multi_topk_fvu / 8).backward()
    return out, {k: t.grad.numpy() for k, t in p.items()}


@pytest.mark.parametrize("multi_topk", [False, True], ids=["topk", "multi_topk"])
@pytest.mark.parametrize("dead", [None, "few", "many"], ids=["no_auxk", "few_dead", "many_dead"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
def test_forward_and_grads_match_jax(fast, dead, multi_topk):
    params = _params()
    x = _x(params)
    dead_mask = _dead(dead)
    jout, jgrads = _jax_run(params, x, JaxSaeConfig(num_latents=L, k=K, multi_topk=multi_topk), dead_mask, fast)
    tout, tgrads = _torch_run(params, x, SaeConfig(num_latents=L, k=K, multi_topk=multi_topk), dead_mask, fast)
    for name in ("fvu", "auxk_loss", "multi_topk_fvu"):
        np.testing.assert_allclose(getattr(tout, name).item(), float(getattr(jout, name)), rtol=RTOL, atol=1e-7)
    assert (tout.auxk_loss.item() > 0) == (dead is not None)
    np.testing.assert_allclose(tout.sae_out.detach().numpy(), np.asarray(jout.sae_out), rtol=RTOL, atol=1e-6)
    if fast:
        fired = tout.fired.numpy()
        np.testing.assert_array_equal(fired, np.asarray(jout.fired))
        assert 0 < fired.sum() < L
    else:
        assert tout.fired is None and jout.fired is None
        np.testing.assert_array_equal(np.sort(tout.latent_indices.numpy(), -1), np.sort(np.asarray(jout.latent_indices), -1))
    for name in params:
        np.testing.assert_allclose(tgrads[name], jgrads[name], rtol=RTOL, atol=1e-7, err_msg=name)


def test_sae_forward_method_is_forward():
    """`Sae.forward` is the module-level forward, with TF32 turned off."""
    params = _params()
    sae = Sae(D, SaeConfig(num_latents=L, k=K), params={k: torch.from_numpy(v.copy()) for k, v in params.items()})
    x = torch.from_numpy(_x(params))
    torch.backends.cuda.matmul.allow_tf32 = True
    a, b = sae(x), forward(sae.params, x, sae.cfg)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.equal(a.sae_out, b.sae_out) and torch.equal(a.fired, b.fired) and a.latent_acts is None
    top = sae(x, return_topk=True)
    assert top.latent_acts.shape == (N, K) and top.latent_indices.dtype == torch.int32


def test_renorm_and_projection_match_jax():
    rng = np.random.default_rng(3)
    params = _params()
    params["W_dec"] = params["W_dec"] * rng.uniform(0.5, 2.0, size=(L, 1)).astype(np.float32)
    ref = jax_renorm({k: jnp.asarray(v) for k, v in params.items()})
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    W_before = p["W_dec"]
    assert set_decoder_norm_to_unit_norm(p) is p and p["W_dec"] is W_before  # in place, stored back
    np.testing.assert_allclose(p["W_dec"].numpy(), np.asarray(ref["W_dec"]), rtol=1e-6, atol=1e-7)
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    jg = jax_project(ref, {k: jnp.asarray(v) for k, v in g.items()})
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    remove_gradient_parallel_to_decoder_directions(p, tg)
    np.testing.assert_allclose(tg["W_dec"].numpy(), np.asarray(jg["W_dec"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tg["W_enc"].numpy(), g["W_enc"])
    assert torch.einsum("ld,ld->l", tg["W_dec"], p["W_dec"]).abs().max() < 1e-5
