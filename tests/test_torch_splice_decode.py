"""The attribution chunk's splice (kernel K2's splice mode, `ops.gather_rows.
splice_decode`) on the CPU, where the wrapper runs its plain version.

* `FastAttribution.drop_positions` against `reselect`: every (f, n) list
  rebuilt from the drop position by hand equals the re-selected one exactly
  (a feature absent, at pool position k, at position 0, a padded ragged
  chunk with repeated features, k == width).
* `splice_decode` against the parent path `gather_decode(reselect) + b_dec`,
  cast to clean's dtype, and against the JAX package's per-feature decode
  (`lax.top_k` of the masked pool, then its `gather_decode`), on the same
  numpy inputs; rows where the feature is outside the token's top-k are
  clean[n] exactly.
* The wrapper's refusals.

Tolerance, as chip_smoke.py holds the decode kernel: each side sums k fp32
products in its own order, so the two differ by at most
2 k 2^-24 max_n sum_j |vals| max |W|; a bf16 side adds one rounding of the
result (2^-8 relative) for each bf16 cast between the sum and the output.
The kernel itself is held bit for bit against the parent path on the card
by chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.ops.sparse_decode import gather_decode as jax_gather_decode
from multimodal_sae_tpu_torch.features.patching.attribution import FastAttribution
from multimodal_sae_tpu_torch.ops import gather_rows as gr

D, WIDTH, K, N = 64, 512, 16, 24
ABSENT = WIDTH - 1  # kept out of every pool below


def _pool(n=N, width=WIDTH, kw=K + 1, seed=0):
    """Per-token pools as `select_topk` gives them: distinct indices (never
    ABSENT while width allows), post-ReLU values in descending order."""
    rng = np.random.default_rng(seed)
    choices = width - 1 if kw < width else width
    idx = np.stack([rng.choice(choices, size=kw, replace=False) for _ in range(n)]).astype(np.int32)
    vals = -np.sort(-np.abs(rng.normal(size=(n, kw)))).astype(np.float32)
    return idx, vals


def _step(idx, vals, k=K):
    """A FastAttribution with its prefix replaced by the given pool."""
    step = FastAttribution.__new__(FastAttribution)
    step.wide_idx, step.wide_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    step.k, step.k_wide = k, idx.shape[1]
    return step


def _lists_by_hand(idx, vals, feats, k):
    """Feature f's list at token n: the pool without f, its first k, closed
    by (0, pool's last index) when the pool is k long and f was in it."""
    out_i, out_v = [], []
    for f in feats:
        for n in range(idx.shape[0]):
            pi, pv = list(idx[n]), list(vals[n])
            if f in pi:
                at = pi.index(f)
                del pi[at], pv[at]
            pi, pv = pi[:k], pv[:k]
            if len(pi) < k:
                pi.append(idx[n, -1])
                pv.append(0.0)
            out_i.append(pi)
            out_v.append(pv)
    return np.array(out_i, dtype=np.int32), np.array(out_v, dtype=np.float32)


def _feats(case, idx, k):
    if case == "absent":
        return [ABSENT]
    if case == "at_k":
        return [int(idx[3, k])]
    if case == "at_0":
        return [int(idx[5, 0])]
    if case == "ragged_padded":  # a tail of 2 padded to 4 with its last feature
        return [int(idx[0, 2]), int(idx[7, k - 1]), int(idx[7, k - 1]), int(idx[7, k - 1])]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["absent", "at_k", "at_0", "ragged_padded", "k_equals_width"])
def test_drop_positions_rebuild_the_reselected_lists(case):
    if case == "k_equals_width":
        idx, vals = _pool(width=K, kw=K, seed=1)
        feats = [int(idx[0, 0]), int(idx[1, K - 1])]
    else:
        idx, vals = _pool()
        feats = _feats(case, idx, K)
    step = _step(idx, vals)
    drop = step.drop_positions(torch.tensor(feats))
    assert drop.dtype == torch.int32 and drop.shape == (len(feats), N)
    for f, row in zip(feats, drop.numpy()):
        expect = [list(idx[n]).index(f) if f in idx[n] else idx.shape[1] for n in range(N)]
        assert row.tolist() == expect
    r_vals, r_idx = step.reselect(torch.tensor(feats))
    h_idx, h_vals = _lists_by_hand(idx, vals, feats, K)
    np.testing.assert_array_equal(r_idx.numpy(), h_idx)
    np.testing.assert_array_equal(r_vals.numpy(), h_vals)
    if case == "absent":
        assert (drop.numpy() == K + 1).all()
    if case == "at_k":
        assert drop[0, 3] == K


def _decoder(dtype, seed=2, width=WIDTH):
    rng = np.random.default_rng(seed)
    W = torch.from_numpy(rng.normal(size=(width, D)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=D).astype(np.float32)).to(dtype)
    return W, b


def _bound(vals, W, k, bf16_roundings=0, ref=None):
    bound = 2 * k * 2.0**-24 * vals.float().abs().sum(-1).max().item() * W.float().abs().max().item()
    if bf16_roundings:
        bound += bf16_roundings * 2.0**-8 * ref.float().abs().max().item()
    return bound


CASES = {
    "fp32": (torch.float32, torch.float32, K + 1),
    "fp32_to_bf16": (torch.float32, torch.bfloat16, K + 1),
    "bf16": (torch.bfloat16, torch.bfloat16, K + 1),
    "bf16_to_fp32": (torch.bfloat16, torch.float32, K + 1),
    "k_equals_width": (torch.float32, torch.float32, K),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_splice_matches_the_parent_path_and_copies_clean_rows(case):
    w_dtype, c_dtype, kw = CASES[case]
    width = WIDTH if kw == K + 1 else K
    idx, vals = _pool(width=width, kw=kw, seed=3)
    W, b = _decoder(w_dtype, width=width)
    step = _step(idx, vals.astype(np.float32))
    pool_vals = step.wide_vals.to(w_dtype)
    clean = (gr.gather_decode(step.wide_idx[:, :K], pool_vals[:, :K], W) + b).to(c_dtype)
    feats = [int(idx[0, 0]), int(idx[4, K - 1]), int(idx[9, kw - 1])]
    if kw == K + 1:
        feats += [ABSENT]
    drop = step.drop_positions(torch.tensor(feats))
    got = gr.splice_decode(step.wide_idx, pool_vals, drop, K, W, b, clean)
    assert got.shape == (len(feats) * N, D) and got.dtype == c_dtype
    r_vals, r_idx = step.reselect(torch.tensor(feats))
    ref = (gr.gather_decode_plain(r_idx, r_vals.to(w_dtype), W) + b).to(c_dtype)
    roundings = (w_dtype == torch.bfloat16) + (c_dtype == torch.bfloat16)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _bound(r_vals, W, K, roundings, ref)
    copy = (drop >= K).reshape(-1)
    # With k == width every feature is in every pool: no copies there.
    assert bool(copy.any()) == (kw == K + 1) and (~copy).any()
    assert torch.equal(got[copy], clean.repeat(len(feats), 1)[copy])
    assert gr.splice_launches == 0


@pytest.mark.parametrize("kw", [K + 1, K], ids=["k_plus_1", "k_equals_width"])
@pytest.mark.parametrize("F", [1, 4])
def test_splice_matches_the_jax_chunk_decode(kw, F):
    """The JAX package's chunk step decodes each feature's `lax.top_k` of
    the pool with the feature masked to -1 (clamped to 0 when it is picked
    in the k == width case), then adds b_dec and casts; the port's splice of
    the same numpy pool agrees within the fp32 bound."""
    width = WIDTH if kw == K + 1 else K
    idx, vals = _pool(width=width, kw=kw, seed=4)
    W, b = _decoder(torch.float32, seed=5, width=width)
    feats = [int(idx[2, 1]), int(idx[6, K - 1]), int(idx[11, kw - 1]), int(idx[0, 0])][:F]
    wi, wv, jW = jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(W.numpy())
    ref = []
    for f in feats:
        masked = jnp.where(wi == f, jnp.asarray(-1.0, wv.dtype), wv)
        vals_k, pos = jax.lax.top_k(masked, K)
        vals_k = jnp.maximum(vals_k, 0.0)
        idx_k = jnp.take_along_axis(wi, pos, axis=1)
        ref.append(np.asarray(jax_gather_decode(idx_k, vals_k, jW) + jnp.asarray(b.numpy())))
    ref = np.concatenate(ref)
    step = _step(idx, vals)
    clean = gr.gather_decode(step.wide_idx[:, :K], step.wide_vals[:, :K], W) + b
    got = gr.splice_decode(step.wide_idx, step.wide_vals, step.drop_positions(torch.tensor(feats)), K, W, b, clean)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_bound(step.wide_vals, W, K))


def test_fast_attribution_splices_what_the_parent_path_decoded(monkeypatch):
    """FastAttribution's chunk decode is the splice, and it agrees with the
    parent path (`decode` of the re-selected lists, cast) on every row."""
    from multimodal_sae_tpu_torch.features.patching import attribution as A
    from multimodal_sae_tpu_torch.sae import decode

    idx, vals = _pool(seed=6)
    W, b = _decoder(torch.float32, seed=7)
    step = _step(idx, vals)
    step.sae = type("S", (), {"params": {"W_dec": W, "b_dec": b}})()
    step.B, step.S, step.mask = 2, N // 2, None
    step.clean = (gr.gather_decode(step.wide_idx[:, :K], step.wide_vals[:, :K], W) + b).reshape(2, N // 2, D)
    seen = {}

    class Stop(Exception):
        """Ends the step after the splice: the suffix is not under test."""

    def splice(*args):
        seen["out"] = gr.splice_decode(*args)
        raise Stop

    monkeypatch.setattr(A, "splice_decode", splice)
    feats = torch.tensor([int(idx[1, 0]), ABSENT, int(idx[8, 5])])
    with pytest.raises(Stop):
        step(feats)
    ref = decode(step.sae.params, *step.reselect(feats)).to(step.clean.dtype)
    assert (seen["out"] - ref).abs().max().item() <= _bound(step.wide_vals, W, K)


def _args():
    idx, vals = _pool(seed=8)
    W, b = _decoder(torch.float32, seed=9)
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    clean = torch.zeros(N, D)
    drop = torch.full((2, N), K + 1, dtype=torch.int32)
    return dict(wide_idx=t_idx, wide_vals=t_vals, drop=drop, k=K, W=W, b_dec=b, clean=clean)


REFUSALS = {
    "vals_shape": (ValueError, lambda a: a.update(wide_vals=a["wide_vals"][:, :K])),
    "drop_rows": (ValueError, lambda a: a.update(drop=a["drop"][:, 1:])),
    "pool_too_wide": (ValueError, lambda a: a.update(k=K - 1)),
    "pool_too_short": (ValueError, lambda a: a.update(k=K + 2)),
    "clean_shape": (ValueError, lambda a: a.update(clean=a["clean"][1:])),
    "b_dec_shape": (ValueError, lambda a: a.update(b_dec=a["b_dec"][1:])),
    "drop_negative": (ValueError, lambda a: a["drop"].__setitem__((0, 3), -1)),
    "drop_past_pool": (ValueError, lambda a: a["drop"].__setitem__((1, 0), K + 2)),
    "mixed_devices": (ValueError, lambda a: a.update(W=torch.empty(WIDTH, D, device="meta"))),
    "fp16_W": (TypeError, lambda a: a.update(W=a["W"].half(), wide_vals=a["wide_vals"].half(),
                                             b_dec=a["b_dec"].half())),
    "vals_dtype": (TypeError, lambda a: a.update(wide_vals=a["wide_vals"].bfloat16())),
    "float_drop": (TypeError, lambda a: a.update(drop=a["drop"].float())),
    "fp16_clean": (TypeError, lambda a: a.update(clean=a["clean"].half())),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_splice_decode_refuses(case):
    error, spoil = REFUSALS[case]
    args = _args()
    gr.splice_decode(**args)  # the unspoiled call runs
    spoil(args)
    with pytest.raises(error):
        gr.splice_decode(**args)
    assert gr.splice_launches == 0
