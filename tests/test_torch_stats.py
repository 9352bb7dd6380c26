"""The port's feature statistics and PCA (features/stats.py, dim_reduce/)
against the JAX package's, on the CPU.

Tolerances: the neighbour and top-token indices exactly and cosine values
within 1e-5 (fp32 sums in other orders; the inputs are drawn so that
neighbouring values differ by more than 1e-4, and a decoder with duplicated
columns holds the stable tie order, lower index first); `unigram` exactly;
PCA components and transforms within 1e-4 up to each component's sign.
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodal_sae_tpu.features.stats as jax_stats
from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.dim_reduce import PcaReducer as JaxPcaReducer
from multimodal_sae_tpu.features.features import Example as JaxExample
from multimodal_sae_tpu.features.features import Feature as JaxFeature
from multimodal_sae_tpu.features.features import FeatureRecord as JaxFeatureRecord
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.features import stats
from multimodal_sae_tpu_torch.features.dim_reduce import PcaReducer, UmapReducer
from multimodal_sae_tpu_torch.features.dim_reduce.pca import gram_components
from multimodal_sae_tpu_torch.features.features import Example, Feature, FeatureRecord
from multimodal_sae_tpu_torch.sae import Sae

COS_ATOL = 1e-5
GAP = 1e-4
PCA_ATOL = 1e-4


class StubTokenizer:
    def batch_decode(self, ids):
        return [f"tok{int(np.asarray(i).ravel()[0])}" for i in ids]


def _saes(d=8, width=48, seed=0, duplicate=False):
    """(port Sae, JAX Sae) with the same parameters; `duplicate` copies
    decoder rows 3 and 10 to rows 20 and 30."""
    jsae = JaxSae(d, JaxSaeConfig(num_latents=width, k=4), key=jax.random.PRNGKey(seed))
    if duplicate:
        W = np.asarray(jsae.params["W_dec"]).copy()
        W[20], W[30] = W[3], W[10]
        jsae.params["W_dec"] = jnp.asarray(W)
    params = sae_params_from_jax({k: np.asarray(v) for k, v in jsae.params.items()}, device="cpu")
    return Sae(d, SaeConfig(num_latents=width, k=4), params=params), jsae


def _gaps_exceed(values, k):
    """Every adjacent pair among each row's k largest differs by > GAP."""
    top = -np.sort(-values, axis=-1)[:, : k + 1]
    return bool((np.abs(np.diff(top, axis=-1)) > GAP).all())


def test_cos_and_neighbors_match_jax():
    sae, jsae = _saes(seed=1)
    sel = np.array([0, 7, 19, 40])
    W = np.asarray(jsae.params["W_dec"]).T
    want_cos = np.asarray(jax_stats.cos(jnp.asarray(W), sel))
    got_cos = stats.cos(torch.from_numpy(W), sel, device="cpu")
    np.testing.assert_allclose(got_cos.numpy(), want_cos, atol=COS_ATOL, rtol=0)
    assert _gaps_exceed(want_cos, 6)
    filt = {"layers.0": sel, "layers.1": np.array([], np.int64)}
    got, got_feats = stats.get_neighbors({"layers.0": sae, "layers.1": sae}, filt, k=6, device="cpu")
    want, want_feats = jax_stats.get_neighbors({"layers.0": jsae, "layers.1": jsae}, filt, k=6)
    assert set(got) == {"layers.0"} and got_feats == want_feats
    for i in range(len(sel)):
        assert got["layers.0"][i]["indices"] == want["layers.0"][i]["indices"]
        np.testing.assert_allclose(got["layers.0"][i]["values"], want["layers.0"][i]["values"], atol=COS_ATOL)


def test_neighbors_keep_the_stable_tie_order():
    """Duplicated decoder rows give exactly equal cosines: the lower index
    comes first on both sides."""
    sae, jsae = _saes(seed=2, duplicate=True)
    filt = {"layers.0": [3, 10, 20, 5]}
    got, _ = stats.get_neighbors({"layers.0": sae}, filt, k=5, device="cpu")
    want, _ = jax_stats.get_neighbors({"layers.0": jsae}, filt, k=5)
    for i in range(4):
        assert got["layers.0"][i]["indices"] == want["layers.0"][i]["indices"]
    # Feature 3's twin (20) is its first neighbour after itself; 20's own
    # top-1 is the lower index 3, and [1:] drops it, leaving 20.
    assert got["layers.0"][0]["indices"][0] == 20 and got["layers.0"][2]["indices"][0] == 20


@pytest.mark.parametrize("w_u_dtype", ["float32", "bfloat16"])
def test_logits_match_jax(w_u_dtype):
    rng = np.random.default_rng(0)
    W_U = rng.normal(size=(200, 8)).astype(np.float32)
    W_dec = rng.normal(size=(8, 32)).astype(np.float32)
    ours = [FeatureRecord(Feature("m", i)) for i in (3, 7, 7, 30)]
    theirs = [JaxFeatureRecord(JaxFeature("m", i)) for i in (3, 7, 7, 30)]
    jw = jnp.asarray(W_U, dtype=getattr(jnp, w_u_dtype))
    tw = torch.from_numpy(W_U).to(getattr(torch, w_u_dtype))
    want = jax_stats.logits(theirs, jw, jnp.asarray(W_dec), k=6, tokenizer=StubTokenizer())
    dla = np.asarray(jnp.matmul(jw, jnp.asarray(W_dec)))
    assert _gaps_exceed(dla.T, 6)
    got = stats.logits(ours, tw, torch.from_numpy(W_dec), k=6, tokenizer=StubTokenizer(), device="cpu")
    assert got == want and [r.top_logits for r in ours] == want


def test_unigram_matches_jax():
    rng = np.random.default_rng(3)
    for reps in (1, 6):
        acts = [rng.random(6).astype(np.float32) * (rng.random(6) > 0.3) for _ in range(10)]
        toks = [rng.integers(0, reps, 6) for _ in range(10)]
        a, b = FeatureRecord(Feature("m", 0)), JaxFeatureRecord(JaxFeature("m", 0))
        a.examples = [Example(t, x) for t, x in zip(toks, acts)]
        b.examples = [JaxExample(t, x) for t, x in zip(toks, acts)]
        for kw in (dict(k=3, threshold=1.0), dict(k=2, threshold=0.5, negative_shift=1), dict(k=20, threshold=0.8)):
            assert stats.unigram(a, **kw) == jax_stats.unigram(b, **kw)


def _same_up_to_sign(got, want, axis):
    """Flip each component (a row of `got` for axis 1, a column for axis 0)
    to `want`'s sign, then compare."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    signs = np.sign((got * want).sum(axis=axis, keepdims=True))
    np.testing.assert_allclose(got * signs, want, atol=PCA_ATOL, rtol=0)


def _gapped(n=200, d=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * np.linspace(3, 0.2, d) + 1.5).astype(np.float32)


@pytest.mark.parametrize("n", [200, 40])
def test_pca_matches_jax(n):
    X = _gapped(n=n)
    ours = PcaReducer(n_components=3, device="cpu").fit(X)
    theirs = JaxPcaReducer(n_components=3).fit(X)
    np.testing.assert_allclose(ours.mean_.numpy(), np.asarray(theirs.mean_), atol=PCA_ATOL)
    _same_up_to_sign(ours.components_.numpy(), theirs.components_, axis=1)
    _same_up_to_sign(ours.transform(X[:50]), theirs.transform(X[:50]), axis=0)
    _same_up_to_sign(PcaReducer(n_components=3, device="cpu").fit_transform(X), theirs.transform(X), axis=0)


def test_pca_fit_sae_list_matches_jax():
    pairs = [_saes(d=8, width=32, seed=s) for s in range(2)]
    ours = PcaReducer(n_components=2, device="cpu").fit_sae_list([p[0] for p in pairs])
    theirs = JaxPcaReducer(n_components=2).fit_sae_list([p[1] for p in pairs])
    _same_up_to_sign(ours.components_.numpy(), theirs.components_, axis=1)
    W = np.asarray(pairs[0][1].params["W_dec"])
    _same_up_to_sign(ours.transform(W), theirs.transform(W), axis=0)


def test_pca_gram_route_equals_the_svd_route():
    """On tall data with a spectral gap (the decoder's shape, n >> d), the
    Gram route's components equal the thin SVD's up to sign, and are
    orthonormal."""
    X = torch.from_numpy(_gapped(n=2048, d=32, seed=4))
    Xc = X - X.mean(dim=0)
    gram = gram_components(Xc, 4)
    svd = torch.linalg.svd(Xc, full_matrices=False).Vh[:4]
    _same_up_to_sign(gram.numpy(), svd.numpy(), axis=1)
    c = gram.double()
    np.testing.assert_allclose(c @ c.T, np.eye(4), atol=1e-5)


def test_umap_reducer_passes_host_arrays(monkeypatch):
    """UmapReducer imports umap when made and hands it numpy arrays (the
    decoders concatenated), as the JAX package's does."""
    seen = []

    class UMAP:
        def __init__(self, n_components, **kw):
            self.n_components = n_components

        def fit(self, X):
            seen.append(X)
            return self

        def transform(self, X):
            return X[:, : self.n_components]

    monkeypatch.setitem(sys.modules, "umap", types.SimpleNamespace(UMAP=UMAP))
    saes = [_saes(d=8, width=16, seed=s)[0] for s in range(2)]
    red = UmapReducer("umap", 2)
    red.fit_sae_list(saes)
    assert isinstance(seen[0], np.ndarray) and seen[0].shape == (32, 8)
    assert red.transform(torch.ones(3, 8)).shape == (3, 2)
