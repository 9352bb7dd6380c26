"""Causal flash attention (kernel K3's function) in the PyTorch port against
the JAX package's `models.llama.flash_attention`, which off the TPU runs
jax's `mha_reference`, and against eager attention.  fp32 on the CPU,
tolerance atol 1e-5: both sides compute fp32 logits, softmax and PV, in
different summation orders.  Fully masked query rows (leading pads under
left padding) must come out finite and equal to the reference's, which
gives them equal weights over all keys.  The CUDA kernel is held against
the same plain version on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models.llama import attention as jax_attention
from multimodal_sae_tpu.models.llama import causal_mask as jax_causal_mask
from multimodal_sae_tpu.models.llama import flash_attention as jax_flash_attention
from multimodal_sae_tpu_torch.models.llama import attention, causal_mask
from multimodal_sae_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5


def _qkv(B, H, kvH, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, kvH, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, kvH, S, hd)).astype(np.float32)
    return q, k, v


def _repeat(q, k, v):
    """The JAX package's attention takes k and v repeated to H heads."""
    rep = q.shape[1] // k.shape[1]
    return np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)


def _pad_mask(B, S, pads):
    return (np.arange(S)[None, :] >= np.asarray(pads)[:, None]).astype(np.int32)


CASES = [
    (2, 4, 4, 64, 16, None, "causal"),
    (2, 4, 4, 100, 16, None, "S not a multiple of 128"),
    (2, 8, 2, 70, 32, None, "GQA, kvH < H"),
    (1, 4, 1, 129, 16, None, "GQA to one kv head, one past a block"),
    (3, 4, 4, 90, 16, [0, 5, 40], "left-padded"),
    (3, 8, 2, 90, 16, [0, 5, 40], "left-padded, GQA"),
    (2, 4, 2, 33, 16, [33, 3], "a row of pads only"),
]


@pytest.mark.parametrize("B,H,kvH,S,hd,pads,case", CASES, ids=[c[-1] for c in CASES])
def test_plain_matches_jax_flash_attention(B, H, kvH, S, hd, pads, case):
    q, k, v = _qkv(B, H, kvH, S, hd)
    scale = hd**-0.5
    pad_mask = None if pads is None else _pad_mask(B, S, pads)
    got = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if pad_mask is None else torch.from_numpy(pad_mask), scale,
    )
    assert got.shape == (B, H, S, hd) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    kr, vr = _repeat(q, k, v)
    ref = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
        None if pad_mask is None else jnp.asarray(pad_mask), scale,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0, err_msg=case)


@pytest.mark.parametrize("S", [20, 128, 130])
def test_fully_masked_rows_take_the_padded_mean_of_v(S):
    """The JAX wrapper pads S to a multiple of 128 with zero keys and values,
    and its finite mask gives a query with no valid key equal weights over
    all of them: the output is sum(v) / round_up(S, 128)."""
    q, k, v = _qkv(1, 2, 2, S, 16, seed=3)
    pad_mask = torch.from_numpy(_pad_mask(1, S, [6]))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pad_mask, 0.25)
    fill = torch.from_numpy(v).sum(dim=2, keepdim=True) / (-(-S // 128) * 128)
    torch.testing.assert_close(got[:, :, :6], fill.expand(1, 2, 6, 16), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pads", [None, [0, 7]])
def test_eager_and_plain_flash_match_jax_eager(pads):
    """The port's eager attention against the JAX package's, and the plain
    flash version against both on real query rows (pad rows differ between
    the eager and the flash masks by design)."""
    B, H, kvH, S, hd = 2, 4, 2, 48, 16
    q, k, v = _qkv(B, H, kvH, S, hd, seed=4)
    kr, vr = _repeat(q, k, v)
    scale = hd**-0.5
    pad_mask = None if pads is None else _pad_mask(B, S, pads)
    ref = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
        jax_causal_mask(S, S, None if pad_mask is None else jnp.asarray(pad_mask)), scale,
    ))
    tmask = causal_mask(S, None if pad_mask is None else torch.from_numpy(pad_mask), torch.device("cpu"))
    eager = attention(torch.from_numpy(q), torch.from_numpy(kr), torch.from_numpy(vr), tmask, scale)
    np.testing.assert_allclose(eager.numpy(), ref, atol=ATOL, rtol=0)
    flash = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if pad_mask is None else torch.from_numpy(pad_mask), scale,
    ).numpy()
    real = np.ones((B, S), bool) if pad_mask is None else pad_mask.astype(bool)
    for b in range(B):
        np.testing.assert_allclose(flash[b][:, real[b]], ref[b][:, real[b]], atol=ATOL, rtol=0)


def test_scale_is_folded_into_q_in_its_dtype():
    """bf16 inputs: the scale rounds to bf16 and multiplies q in bf16 before
    the product, as the JAX wrapper does (llama.py:330)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 2, 2, 8, 16, seed=2))
    scale = 16**-0.5 * 1.01  # not a power of two: rounding matters
    got = fa.flash_attention_plain(q, k, v, None, scale)
    q_scaled = q * torch.tensor(scale, dtype=torch.bfloat16)
    ref = fa.flash_attention_plain(q_scaled, k, v, None, 1.0)
    assert torch.equal(got, ref)


@pytest.mark.parametrize(
    "q_shape,kv_shape,pad_shape",
    [
        ((1, 4, 8, 16), (1, 3, 8, 16), None),  # H not a multiple of kvH
        ((1, 4, 8, 16), (1, 2, 9, 16), None),  # S differs
        ((1, 4, 8, 16), (1, 2, 8, 16), (1, 9)),  # pad mask shape
    ],
)
def test_flash_attention_rejects_shapes(q_shape, kv_shape, pad_shape):
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    pad = None if pad_shape is None else torch.ones(pad_shape)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, pad, 0.25)


def test_cpu_dispatch_counts_nothing():
    fa.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 5, 16))
    fa.flash_attention(q, k, v, None, 0.25)
    assert fa.launches == 0
