"""Exact wide top-k and the index sort of the PyTorch port against the JAX
package on the same arrays: per row the index sets are equal and the values
bit-equal (like `torch.topk(sorted=False)`, the order within the k is
unspecified); `sort_pairs_by_index` gives the same order, payload bits
included."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multimodal_sae_tpu.ops import sort_pairs_by_index as jax_sort_pairs
from multimodal_sae_tpu.ops import top_k as jax_top_k
from multimodal_sae_tpu_torch.ops import blockmax_top_k, blockwise_top_k, sort_pairs_by_index, top_k
from multimodal_sae_tpu_torch.ops import block_max as bm


def _pairs(v, i):
    return {int(a): np.asarray(b).tobytes() for a, b in zip(np.asarray(i), np.asarray(v))}


@pytest.mark.parametrize(
    "n,width,k,assume_finite,path",
    [
        (4, 32768, 16, False, "blockmax, one level (block 64)"),
        (4, 32768, 128, True, "blockmax, two levels (k*block > 4096)"),
        (3, 65536, 1024, False, "blockmax at block 16, two levels"),
        (5, 5000, 37, False, "blockwise"),
        (3, 40000, 16, False, "width not a multiple of the block"),
    ],
)
def test_top_k_matches_jax_as_sets(n, width, k, assume_finite, path):
    x = np.random.default_rng(width + k).normal(size=(n, width)).astype(np.float32)
    jv, ji = jax_top_k(jnp.asarray(x), k, assume_finite=assume_finite)
    tv, ti = top_k(torch.from_numpy(x), k, assume_finite=assume_finite)
    assert ti.dtype == torch.int32 and tv.shape == (n, k)
    for r in range(n):
        assert _pairs(tv[r].numpy(), ti[r].numpy()) == _pairs(jv[r], ji[r]), path


def test_top_k_neg_inf_values_match_jax():
    """Rows with fewer finite entries than k: the block-max path returns the
    dtype's finite minimum for -inf picks, as the JAX package's clamped
    gather does; which -inf entries fill the k is a tie, so compare the
    finite picks as sets and all values as sorted bits."""
    rng = np.random.default_rng(7)
    x = np.full((3, 32768), -np.inf, np.float32)
    for r in range(3):
        x[r, rng.choice(32768, size=5 + r, replace=False)] = rng.normal(size=5 + r)
    jv, ji = jax_top_k(jnp.asarray(x), 16)
    tv, ti = top_k(torch.from_numpy(x), 16)
    for r in range(3):
        np.testing.assert_array_equal(np.sort(tv[r].numpy()), np.sort(np.asarray(jv[r])))
        finite = lambda v, i: {int(a) for a, b in zip(np.asarray(i), np.asarray(v)) if b > -3e38}
        assert finite(tv[r].numpy(), ti[r].numpy()) == finite(jv[r], ji[r])


def test_top_k_leading_dims_and_fallbacks():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 32768)).astype(np.float32))
    v, i = top_k(x, 16)
    assert v.shape == i.shape == (2, 3, 16)
    assert torch.equal(i.sort(-1).values.long(), torch.topk(x, 16).indices.sort(-1).values)
    # blockmax refuses what it cannot filter and takes the exact path
    for shape, k in (((2, 1000), 64), ((2, 32770), 16)):
        x = torch.randn(shape)
        vb, ib = blockmax_top_k(x, k)
        vw, iw = blockwise_top_k(x, k)
        assert torch.equal(vb, vw) and torch.equal(ib, iw)


@pytest.mark.parametrize("n,k,dtype", [(16, 256, "float32"), (4, 1024, "bfloat16"), (7, 33, "float32")])
def test_sort_pairs_by_index_matches_jax(n, k, dtype):
    """Unique indices (top-k output) with -inf, NaN and bf16 payloads."""
    rng = np.random.default_rng(k)
    idx = np.stack([rng.permutation(1 << 20)[:k] for _ in range(n)]).astype(np.int32)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    vals[:, 0] = -np.inf
    vals[:, 1] = np.nan
    ji, jv = jax_sort_pairs(jnp.asarray(idx), jnp.asarray(vals).astype(dtype), max_index=1 << 20)
    ti, tv = sort_pairs_by_index(torch.from_numpy(idx), torch.from_numpy(vals).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    a, b = np.asarray(jv, np.float32), tv.float().numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


@settings(max_examples=30, deadline=None, database=None)
@given(
    n=st.integers(1, 4),
    width=st.sampled_from([257, 4097, 32768, 65536, 40000]),
    k_frac=st.floats(0.001, 0.2),
    dtype=st.sampled_from([torch.float32, torch.bfloat16]),
    ties=st.booleans(),
    masked_tail=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_top_k_property_sweep(n, width, k_frac, dtype, ties, masked_tail, seed):
    """Seeded fuzz over widths (block multiples and not), k, dtypes, heavy
    ties and -inf tails, against a numpy sort: the picked values are the
    top-k multiset, the indices unique and pointing at those values (an -inf
    pick may read as the dtype's finite minimum, as in the JAX package)."""
    k = max(1, int(width * k_frac))
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, width))
    if ties:
        base = np.round(base * 2) / 2
    if masked_tail:
        base[:, rng.integers(1, width):] = -np.inf
    x = torch.from_numpy(base.astype(np.float32)).to(dtype)
    v, i = top_k(x, k)
    xf = x.float().numpy()
    lowest = float(torch.finfo(dtype).min)
    for r in range(n):
        picked = xf[r, i[r].long().numpy()]
        np.testing.assert_array_equal(np.sort(picked), np.sort(xf[r])[-k:])
        got = v[r].float().numpy()
        np.testing.assert_array_equal(np.where(np.isneginf(picked) & (got == lowest), -np.inf, got), picked)
        assert len(set(i[r].tolist())) == k


def test_top_k_reduces_through_block_max_wrapper(monkeypatch):
    """The cache step's top-k (k=256 over 131,072) goes through the K1
    wrapper at both filter levels: block 64, then block 8."""
    calls = []
    real = bm.block_max

    def spy(x, block):
        calls.append((tuple(x.shape), block))
        return real(x, block)

    monkeypatch.setattr("multimodal_sae_tpu_torch.ops.topk.block_max", spy)
    top_k(torch.randn(2, 131072), 256, assume_finite=True)
    assert calls == [((2, 131072), 64), ((2, 16384), 8)]
