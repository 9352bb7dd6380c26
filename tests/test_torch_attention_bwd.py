"""The backward of causal flash attention (kernel K3's backward) in the
PyTorch port against `jax.vjp` of the JAX package's
`models.llama.flash_attention`, which off the TPU runs jax's `mha_reference`
and its custom VJP `mha_reference_bwd`.  The port's gradient runs through
its autograd Function, which on the CPU pairs the plain forward with
`flash_attention_bwd_plain`.

Tolerances: fp32 atol 1e-5 (fp32 logits, softmax and products on both
sides, summed in different orders over at most 90 keys).  bf16: within
2^-6 of the largest gradient entry (two to four bf16 ulps there).  Both
sides compute in fp32 from bf16 inputs and the bf16 forward output, but the
JAX side rebuilds P from its forward's (m, l) and sums dk and dv over the
query heads of a kv head after rounding each to bf16, and dq is rounded
twice (before and after the scale) on both sides; sums of terms larger than
their result show such differences at a few ulps.

Rows with no valid key (leading pads under left padding): jax's reference
spreads their dO over every key; the port gives them dq = 0 and adds
nothing from them.  The two agree when dO is 0 on those rows, which is what
the attribution path gives them (tests/test_torch_attribution.py shows it on
both sides), so every comparison with a pad mask zeroes dO there.  The CUDA
kernels are held against the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models.llama import _repeat_kv
from multimodal_sae_tpu.models.llama import flash_attention as jax_flash_attention
from multimodal_sae_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from multimodal_sae_tpu_torch.ops import flash_attention as fa

FP32_ATOL = 1e-5
BF16_REL = 2.0**-6


def _inputs(B, H, kvH, S, hd, pads, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, kvH, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, kvH, S, hd)).astype(np.float32)
    do = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    pad_mask = None
    if pads is not None:
        pad_mask = (np.arange(S)[None, :] >= np.asarray(pads)[:, None]).astype(np.int32)
        # A leading pad row has no valid key (causal + left padding): dO 0.
        do = do * pad_mask[:, None, :, None]
    return q, k, v, do, pad_mask


def _cast(a, dtype):
    return a if dtype == "float32" else np.asarray(jnp.asarray(a, jnp.bfloat16))


def _jax_grads(q, k, v, do, pad_mask, scale):
    rep = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jax_flash_attention(
            q, _repeat_kv(k, rep), _repeat_kv(v, rep),
            None if pad_mask is None else jnp.asarray(pad_mask), scale,
        )

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, pad_mask, scale):
    qt, kt, vt = (tensor_from_numpy(a, "cpu").requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, None if pad_mask is None else torch.from_numpy(pad_mask), scale)
    grads = torch.autograd.grad(out, (qt, kt, vt), tensor_from_numpy(do, "cpu"))
    return out, grads


CASES = [
    (2, 4, 4, 40, 16, None, "causal"),
    (2, 8, 2, 70, 32, None, "GQA, kvH < H"),
    (1, 4, 1, 33, 16, None, "GQA to one kv head"),
    (3, 4, 2, 90, 16, [0, 5, 40], "left-padded, GQA"),
    (2, 4, 2, 33, 16, [33, 3], "a row of pads only"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,kvH,S,hd,pads,case", CASES, ids=[c[-1] for c in CASES])
def test_backward_matches_jax_vjp(B, H, kvH, S, hd, pads, case, dtype):
    """dq (with respect to the unscaled q, through the multiply by a scale
    that is not a power of two), dk and dv summed over each kv head's query
    heads, against `jax.vjp` of the JAX wrapper."""
    q, k, v, do, pad_mask = _inputs(B, H, kvH, S, hd, pads)
    q, k, v, do = (_cast(a, dtype) for a in (q, k, v, do))
    scale = hd**-0.5 * 1.01
    ref_out, ref = _jax_grads(q, k, v, do, pad_mask, scale)
    out, got = _port_grads(q, k, v, do, pad_mask, scale)
    assert out.dtype == getattr(torch, dtype)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g = tensor_to_numpy(g).astype(np.float32)
        r = r.astype(np.float32)
        assert g.shape == r.shape and np.isfinite(g).all()
        atol = FP32_ATOL if dtype == "float32" else BF16_REL * np.abs(r).max()
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=f"{case} {name}")


def test_autograd_function_equals_the_plain_pair():
    """On the CPU the autograd Function runs the plain forward and the plain
    backward on the forward's saved output and logsumexp: equal bits."""
    q, k, v, do, pad_mask = _inputs(2, 8, 2, 50, 16, [0, 9], seed=1)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    pm = torch.from_numpy(pad_mask)
    out, grads = _port_grads(*(tensor_to_numpy(t) for t in (q, k, v, do)), pad_mask, 0.2)
    ref_out, lse = fa.flash_attention_fwd_plain(q, k, v, pm, 0.2)
    assert torch.equal(out.detach(), ref_out)
    assert torch.equal(out.detach(), fa.flash_attention_plain(q, k, v, pm, 0.2))
    ref = fa.flash_attention_bwd_plain(q, k, v, pm, ref_out, lse, do, 0.2)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)
    assert fa.launches == 0 and fa.bwd_delta_launches == 0
    assert fa.bwd_dkdv_launches == 0 and fa.bwd_dq_launches == 0


def test_rows_without_a_valid_key_get_no_gradient():
    """With dO nonzero on the leading pad rows, the port still gives them
    dq = 0 and takes nothing from them into dk or dv: the gradients equal
    those with dO zeroed there.  Their logsumexp is +inf."""
    q, k, v, _, pad_mask = _inputs(2, 4, 2, 30, 16, [0, 7], seed=2)
    do = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    _, got = _port_grads(q, k, v, do, pad_mask, 0.25)
    _, zeroed = _port_grads(q, k, v, do * pad_mask[:, None, :, None], pad_mask, 0.25)
    assert not got[0][1, :, :7].any()
    for g, z in zip(got, zeroed):
        assert torch.equal(g, z)
    _, lse = fa.flash_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pad_mask), 0.25)
    assert torch.isinf(lse[1, :, :7]).all() and torch.isfinite(lse[1, :, 7:]).all()
    assert torch.isfinite(lse[0]).all()


def test_no_autograd_no_function():
    """Without autograd the forward keeps no statistics (the capture path's
    call), and a tensor that needs no grad takes the plain forward."""
    q, k, v, _, _ = _inputs(1, 2, 1, 9, 16, None)
    with torch.no_grad():
        out = fa.flash_attention(*(torch.from_numpy(a).requires_grad_() for a in (q, k, v)), None, 0.25)
    assert out.grad_fn is None
    out = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), None, 0.25)
    assert out.grad_fn is None


def test_backward_rejects_mismatched_shapes():
    q, k, v, do, _ = _inputs(1, 4, 2, 8, 16, None)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, None, 0.25)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k[:, :, :7], v, None, o, lse, do, 0.25)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, torch.ones(1, 9), o, lse, do, 0.25)
