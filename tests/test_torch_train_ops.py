"""The training slice's ops in the PyTorch port against the JAX package, on
inputs drawn from numpy seeds:

* `kth_value`: equal bits (fp32 and bf16; -inf rows, ties, signed zeros,
  fewer than k finite entries);
* `topk_mask_decode`: equal masks (both thresholds are exact), `y` and
  `dense` within fp32 rtol 1e-5, on both sides of the k·256 = width
  dispatch and through the block-max filter;
* `sparse_decode`'s backward against the JAX custom VJP, and `dW_chunked`
  against `_dW_chunked` across a chunk boundary: rtol 1e-5 (fp32 sums in
  other orders);
* K2's dvals mode, run through its plain version here, against the
  gather-dot: rtol 1e-5 fp32, one bf16 step for a bf16 output;
* `geometric_median`: within 1e-5 of the JAX result (the same iteration,
  fp32 reductions in other orders);
* Adam against `optax.scale_by_adam` over three steps on identical
  gradients: updates and moments within rtol 1e-6 (the bias corrections'
  fp32 `pow` may differ by an ulp), count equal, leaves in the JAX order;
* 8-bit Adam against `scale_by_adam8bit`: the same leaf order, shapes and
  dtypes; stored codes equal but for at most one element in 10,000 one step
  off (the libraries' fp32 `pow` may round the companded value across a
  half-step); updates within 1e-6.
The CUDA kernel is held against the same plain version by chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import optax
import torch

from multimodal_sae_tpu.ops.adam8bit import scale_by_adam8bit
from multimodal_sae_tpu.ops.geometric_median import geometric_median as jax_geometric_median
from multimodal_sae_tpu.ops.sparse_decode import _dW_chunked as jax_dW_chunked
from multimodal_sae_tpu.ops.sparse_decode import sparse_decode as jax_sparse_decode
from multimodal_sae_tpu.ops.sparse_decode import topk_mask_decode as jax_topk_mask_decode
from multimodal_sae_tpu.ops.topk import kth_value as jax_kth_value
from multimodal_sae_tpu_torch.convert import opt_state_from_jax, opt_state_to_jax, tensor_from_numpy
from multimodal_sae_tpu_torch.ops import gather_rows as gr
from multimodal_sae_tpu_torch.ops.adam import ScaleByAdam, flatten_state
from multimodal_sae_tpu_torch.ops.adam8bit import ScaleByAdam8bit
from multimodal_sae_tpu_torch.ops.geometric_median import geometric_median
from multimodal_sae_tpu_torch.ops.sparse_decode import dW_chunked, sparse_decode, topk_mask_decode
from multimodal_sae_tpu_torch.ops.topk import kth_value

RTOL = 1e-5


def _kth_rows(dtype):
    """(50, 300) rows with the cases `kth_value` must keep bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 300)).astype(np.float32)
    x[0] = -np.inf                        # every entry -inf
    x[1, :250] = -np.inf                  # 50 finite: k > 50 gives -inf
    x[2] = np.round(x[2])                 # heavy ties
    x[3] = 0.0
    x[3, ::2] = -0.0                      # signed zeros, -0.0 ranks below +0.0
    x[4] = -0.0
    x[4, :5] = 0.0
    x[5, 100:] = np.inf
    return x.astype(dtype)


@pytest.mark.parametrize("k", [1, 7, 50, 100, 299, 300])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["fp32", "bf16"])
def test_kth_value_bits_match_jax(dtype, k):
    x = _kth_rows(dtype)
    ref = np.asarray(jax_kth_value(jnp.asarray(x), k))
    got = kth_value(tensor_from_numpy(x, "cpu"), k)
    assert got.shape == (50, 1)
    ib = np.int16 if dtype is not np.float32 else np.int32
    np.testing.assert_array_equal(got.view(torch.int16 if ib is np.int16 else torch.int32).numpy(), ref.view(ib))


def test_kth_value_keys_in_row_chunks(monkeypatch):
    """Rows keyed a few at a time give what one pass gives."""
    from multimodal_sae_tpu_torch.ops import topk

    x = tensor_from_numpy(_kth_rows(np.float32), "cpu")
    whole = kth_value(x, 37)
    monkeypatch.setattr(topk, "KTH_CHUNK_ELEMENTS", 7 * 300)
    assert torch.equal(kth_value(x, 37).view(torch.int32), whole.view(torch.int32))


def _pre_acts(n, width, seed):
    """Post-ReLU pre-activations: rows with fewer than k positives (ties at
    0) and a row with a tie at a positive k-th value."""
    rng = np.random.default_rng(seed)
    pre = np.maximum(rng.standard_normal((n, width)).astype(np.float32), 0)
    pre[0, 3:] = 0.0  # 3 positives
    pre[1, :] = np.round(pre[1] * 4) / 4  # ties everywhere
    return pre


@pytest.mark.parametrize("width,k", [(256, 1), (256, 4), (32768, 128)], ids=["top_k", "kth_value", "block_max"])
def test_topk_mask_decode_matches_jax(width, k):
    n, d = 6, 8
    pre = _pre_acts(n, width, seed=width + k)
    W = np.random.default_rng(1).standard_normal((width, d)).astype(np.float32)
    jy, jdense, jmask = (np.asarray(a) for a in jax_topk_mask_decode(jnp.asarray(pre), jnp.asarray(W), k))
    y, dense, mask = topk_mask_decode(torch.from_numpy(pre), torch.from_numpy(W), k)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert (mask.sum(-1) >= k).all()
    assert bool(mask[0].all()) == (k > 3)  # row 0 has 3 positives: beyond k = 3 it ties at 0, all kept
    np.testing.assert_allclose(dense.numpy(), jdense, rtol=RTOL)
    np.testing.assert_allclose(y.numpy(), jy, rtol=RTOL, atol=1e-5)


def _decode_inputs(n, k, L, d, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(L, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    vals = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    W = rng.normal(size=(L, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    return idx, vals, W, g


@pytest.mark.parametrize("n", [5, 1100], ids=["one_slab", "two_slabs"])
def test_sparse_decode_backward_matches_jax_vjp(n):
    idx, vals, W, g = _decode_inputs(n, 4, 64, 8)
    y, vjp = jax.vjp(lambda v, w: jax_sparse_decode(jnp.asarray(idx), v, w), jnp.asarray(vals), jnp.asarray(W))
    jd_vals, jd_W = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tv, tW = torch.from_numpy(vals).requires_grad_(), torch.from_numpy(W).requires_grad_()
    out = sparse_decode(torch.from_numpy(idx), tv, tW)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=RTOL, atol=1e-6)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tv.grad.numpy(), jd_vals, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(tW.grad.numpy(), jd_W, rtol=RTOL, atol=1e-5)


def test_dW_chunked_matches_jax_across_a_chunk_boundary():
    idx, vals, _, g = _decode_inputs(10, 3, 40, 6, seed=3)
    ref = np.asarray(jax_dW_chunked(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(g), 40, chunk=4))
    got = dW_chunked(torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(g), 40, chunk=4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("w_dtype,out_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                               (torch.bfloat16, torch.bfloat16)], ids=["fp32", "bf16_W", "bf16_out"])
def test_decode_dvals_plain_is_the_gather_dot(w_dtype, out_dtype):
    """300 tokens: three of the plain version's 128-token gathers."""
    idx, _, W, g = _decode_inputs(300, 5, 50, 16, seed=4)
    tW = torch.from_numpy(W).to(w_dtype)
    got = gr.decode_dvals(torch.from_numpy(g), torch.from_numpy(idx), tW, out_dtype)
    ref = np.einsum("nd,nkd->nk", g.astype(np.float64), tW.float().numpy().astype(np.float64)[idx])
    assert got.dtype == out_dtype and got.shape == (300, 5)
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -8, atol=1e-5)


def test_decode_dvals_refuses_mismatched_shapes():
    idx, _, W, g = _decode_inputs(4, 2, 10, 8)
    with pytest.raises(ValueError):
        gr.decode_dvals(torch.from_numpy(g[:3]), torch.from_numpy(idx), torch.from_numpy(W), torch.float32)
    with pytest.raises(TypeError):
        gr.decode_dvals(torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(W), torch.float16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_points"])
def test_geometric_median_matches_jax(bf16):
    """fp32 points, and bf16 ones as the subject's hidden states come."""
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((200, 16)).astype(np.float32) * 3 + 1
    pts[:20] = pts[0]  # duplicated rows: distances clamp at 1e-12
    t = torch.from_numpy(pts).to(torch.bfloat16 if bf16 else torch.float32)
    ref = np.asarray(jax_geometric_median(jnp.asarray(t.float().numpy())))
    got = geometric_median(t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


SHAPES = {"W_dec": (64, 80), "W_enc": (80, 64), "b_dec": (80,), "b_enc": (64,)}


def _grads(rng):
    """Gradients spanning four decades, as a trained SAE's do."""
    return {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0, size=s)).astype(np.float32) for k, s in SHAPES.items()}


def _as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _as_torch(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


@pytest.mark.parametrize("eight_bit", [False, True], ids=["adam", "adam8bit"])
def test_adam_matches_optax_over_three_steps(eight_bit):
    rng = np.random.default_rng(6)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = scale_by_adam8bit() if eight_bit else optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    topt = ScaleByAdam8bit() if eight_bit else ScaleByAdam(b1=0.9, b2=0.999, eps=1e-8)
    js, ts = jopt.init(_as_jax(params)), topt.init(_as_torch(params))
    for step in range(3):
        g = _grads(rng)
        ju, js = jopt.update(_as_jax(g), js)
        tu, ts = topt.update(_as_torch(g), ts)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-6)
        jleaves = jax.tree_util.tree_flatten(js)[0]
        tleaves = flatten_state(ts)
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves] == \
               [(tuple(a.shape), str(a.dtype)) for a in jleaves]
        for a, t in zip(jleaves, tleaves):
            a, t = np.asarray(a), t.numpy()
            if a.dtype.kind in "iu":
                off = a.astype(np.int64) - t.astype(np.int64)
                assert np.abs(off).max(initial=0) <= 1 and (off != 0).sum() <= max(1, a.size // 10000)
            else:
                np.testing.assert_allclose(t, a, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("eight_bit", [False, True], ids=["adam", "adam8bit"])
def test_opt_state_crosses_both_ways(eight_bit):
    """JAX leaves -> the port's state -> leaves: equal bits both ways."""
    rng = np.random.default_rng(7)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = scale_by_adam8bit() if eight_bit else optax.scale_by_adam()
    js = jopt.init(_as_jax(params))
    _, js = jopt.update(_as_jax(_grads(rng)), js)
    flat = {f"leaf_{i}": np.asarray(a) for i, a in enumerate(jax.tree_util.tree_flatten(js)[0])}
    topt = ScaleByAdam8bit() if eight_bit else ScaleByAdam()
    state = opt_state_from_jax(flat, topt.init(_as_torch(params)))
    assert int(state.count) == 1
    back = opt_state_to_jax(state)
    assert back.keys() == flat.keys()
    for key in flat:
        assert back[key].dtype == flat[key].dtype and back[key].tobytes() == flat[key].tobytes()
