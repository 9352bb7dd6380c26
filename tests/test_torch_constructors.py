"""The port's example construction and sampling (features/constructors.py,
samplers.py, features.py) against the JAX package's, on numpy-seeded
BufferOutputs: the text constructors' windows exactly (tokens) and bit for
bit (activations); the image constructors on a tiny image dataset, their
PIL images equal byte for byte; the samplers draw for draw; records saved to
the same JSON bytes."""

import random

import numpy as np
import pytest
from PIL import Image

import multimodal_sae_tpu.features.constructors as jax_ctors
import multimodal_sae_tpu.features.features as jax_features
import multimodal_sae_tpu.features.samplers as jax_samplers
import multimodal_sae_tpu_torch.features.constructors as ctors
import multimodal_sae_tpu_torch.features.features as features
import multimodal_sae_tpu_torch.features.samplers as samplers
from multimodal_sae_tpu.config import ExperimentConfig as JaxExperimentConfig
from multimodal_sae_tpu.config import FeatureConfig as JaxFeatureConfig
from multimodal_sae_tpu.features.loader import BufferOutput as JaxBufferOutput
from multimodal_sae_tpu_torch.config import ExperimentConfig, FeatureConfig
from multimodal_sae_tpu_torch.features.loader import BufferOutput

ROWS, SEQ = 12, 32


def _buffer_output(seed=0, n=120, rows=ROWS, seq=SEQ, dtype=np.float32):
    rng = np.random.default_rng(seed)
    loc = np.stack([rng.integers(0, rows, n), rng.integers(0, seq, n)], axis=1).astype(np.int64)
    loc = loc[np.lexsort((loc[:, 1], loc[:, 0]))]
    return loc, rng.random(n).astype(dtype)


def _pair(loc, acts, feature=7):
    return (BufferOutput(features.Feature("m", feature), loc, acts),
            JaxBufferOutput(jax_features.Feature("m", feature), loc, acts))


def _examples(examples):
    return [(e.tokens.dtype.str, e.tokens.tolist(), e.activations.dtype.str, e.activations.tobytes())
            for e in examples or []]


def _images(examples):
    return [tuple((im.mode, im.size, im.tobytes()) for im in (e.image, e.activation_image, e.mask))
            for e in examples]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_constructors_match_jax(seed, dtype):
    loc, acts = _buffer_output(seed, dtype=dtype)
    tokens = np.random.default_rng(seed + 10).integers(0, 500, size=(ROWS, SEQ))
    ours, theirs = _pair(loc, acts)
    for ctx_len, max_examples in ((4, 5), (8, 100), (5, 3)):
        a, b = features.FeatureRecord(ours.feature), jax_features.FeatureRecord(theirs.feature)
        ctors.pool_max_activation_windows(a, ours, tokens, FeatureConfig(example_ctx_len=ctx_len, max_examples=max_examples))
        jax_ctors.pool_max_activation_windows(b, theirs, tokens,
                                              JaxFeatureConfig(example_ctx_len=ctx_len, max_examples=max_examples))
        assert _examples(a.examples) == _examples(b.examples) and a.examples
        a, b = features.FeatureRecord(ours.feature), jax_features.FeatureRecord(theirs.feature)
        ctors.default_constructor(a, tokens, ours, n_random=4, ctx_len=ctx_len, max_examples=max_examples)
        jax_ctors.default_constructor(b, tokens, theirs, n_random=4, ctx_len=ctx_len, max_examples=max_examples)
        assert _examples(a.examples) == _examples(b.examples)
        assert _examples(a.random_examples) == _examples(b.random_examples)
    for seed_r in (0, 22):
        a, b = features.FeatureRecord(ours.feature), jax_features.FeatureRecord(theirs.feature)
        ctors.random_activation_windows(a, tokens, ours, 4, 3, seed=seed_r)
        jax_ctors.random_activation_windows(b, tokens, theirs, 4, 3, seed=seed_r)
        assert _examples(a.random_examples) == _examples(b.random_examples)


def test_dense_and_pools_match_jax():
    loc, acts = _buffer_output(3)
    loc = np.concatenate([loc, loc[:5]])  # repeated entries add up
    acts = np.concatenate([acts, acts[:5]])
    tokens = np.arange(ROWS * SEQ).reshape(ROWS, SEQ)
    got, want = ctors._to_dense(tokens, acts, loc), jax_ctors._to_dense(tokens, acts, loc)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # Equal pools: the stable descending order keeps the lower window first.
    dense = np.zeros((4, 16), np.float32)
    dense[:, 3] = 1.0
    dense[2, 9] = 2.0
    for g, w in zip(ctors._top_k_pools(dense, tokens[:4, :16], 4, 10), jax_ctors._top_k_pools(dense, tokens[:4, :16], 4, 10)):
        np.testing.assert_array_equal(g, w)


class _ImageDataset:
    """A tiny image dataset with the columns "image" and (optionally) "id"."""

    def __init__(self, n, with_ids, seed=0):
        rng = np.random.default_rng(seed)
        self.rows = [
            {"image": Image.fromarray(rng.integers(0, 256, size=(20 + 3 * i, 24, 3), dtype=np.uint8)), "id": i // 2}
            for i in range(n)
        ]
        self.column_names = ["image", "id"] if with_ids else ["image"]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


@pytest.mark.parametrize("with_ids", [False, True], ids=["no ids", "duplicate ids"])
def test_image_constructors_match_jax(with_ids):
    n_images, n_tok = 8, 16  # 4 x 4 base-image grid
    dataset = _ImageDataset(n_images, with_ids)
    loc, acts = _buffer_output(4, n=90, rows=n_images, seq=n_tok + 5)
    ours, theirs = _pair(loc, acts)
    for name in ("pool_max_activations_windows_image", "random_activations_image"):
        kw = {"seed": 3} if name == "random_activations_image" else {}
        a, b = features.FeatureRecord(ours.feature), jax_features.FeatureRecord(theirs.feature)
        getattr(ctors, name)(a, ours, dataset, FeatureConfig(max_examples=3), num_image_tokens=n_tok, **kw)
        getattr(jax_ctors, name)(b, theirs, dataset, JaxFeatureConfig(max_examples=3), num_image_tokens=n_tok, **kw)
        assert len(a.examples) == 3
        assert _examples(a.examples) == _examples(b.examples)
        assert _images(a.examples) == _images(b.examples)


def test_upsample_mask_and_image_examples_match_jax():
    rng = np.random.default_rng(0)
    mask = rng.random((5, 5)) * (rng.random((5, 5)) > 0.5)
    for kw in ({}, {"value": 100, "resample": Image.NEAREST}):
        a, b = features.upsample_mask(mask, (40, 30), **kw), jax_features.upsample_mask(mask, (40, 30), **kw)
        assert (a.mode, a.size, a.tobytes()) == (b.mode, b.size, b.tobytes())
    images = [Image.fromarray(rng.integers(0, 256, size=(30, 40, 3), dtype=np.uint8)) for _ in range(2)]
    acts = rng.random((2, 729 + 4)).astype(np.float32)
    a = features.prepare_image_examples(np.zeros((2, 733)), acts, images, num_image_tokens=729)
    b = jax_features.prepare_image_examples(np.zeros((2, 733)), acts, images, num_image_tokens=729)
    assert _images(a) == _images(b) and a[0].mask.size == (384, 384)


def _text_examples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [features.Example(rng.integers(0, 100, 6), rng.random(6).astype(np.float32)) for _ in range(n)]


def _as_jax(examples):
    return [jax_features.Example(e.tokens, e.activations) for e in examples]


@pytest.mark.parametrize("train_type", ["top", "random", "quantile"])
def test_samplers_match_jax_draw_for_draw(train_type):
    examples = sorted(_text_examples(23), key=lambda e: -e.max_activation)
    for seed in (22, 5):
        random.seed(1)
        got = samplers.train(examples, 7, train_type, seed=seed, n_quantiles=3)
        after_ours = random.random()
        random.seed(1)
        want = jax_samplers.train(_as_jax(examples), 7, train_type, seed=seed, n_quantiles=3)
        assert _examples(got) == _examples(want) and random.random() == after_ours
    with pytest.raises(ValueError, match="Invalid train_type"):
        samplers.train(examples, 3, "best")


def test_quantile_splitters_match_jax():
    examples = sorted(_text_examples(40, 1), key=lambda e: -e.max_activation)
    for n_q, n_s in ((4, 3), (3, 20)):
        got = samplers.split_activation_quantiles(examples, n_q, n_s, seed=9)
        want = jax_samplers.split_activation_quantiles(_as_jax(examples), n_q, n_s, seed=9)
        assert [_examples(g) for g in got] == [_examples(w) for w in want]
        assert _examples(samplers.split_quantiles(examples, n_q, n_s)) == \
            _examples(jax_samplers.split_quantiles(_as_jax(examples), n_q, n_s))


def test_sample_with_explanation_matches_jax():
    examples = _text_examples(12, 2)
    cfgs = (ExperimentConfig(train_type="random", n_examples_train=4),
            JaxExperimentConfig(train_type="random", n_examples_train=4))
    explanations = {"m_feature1": "one"}
    for mod, feats, ex, cfg in ((samplers, features, examples, cfgs[0]),
                                (jax_samplers, jax_features, _as_jax(examples), cfgs[1])):
        r = feats.FeatureRecord(feats.Feature("m", 1))
        r.examples = ex
        mod.sample_with_explanation(r, cfg, explanations)
        assert r.explanation == "one" and len(r.train) == 4
        r2 = feats.FeatureRecord(feats.Feature("m", 2))
        r2.examples = ex
        with pytest.raises(mod.SkipRecord):
            mod.sample_with_explanation(r2, cfg, explanations)
    a, b = features.FeatureRecord(features.Feature("m", 1)), jax_features.FeatureRecord(jax_features.Feature("m", 1))
    a.examples, b.examples = examples, _as_jax(examples)
    samplers.sample(a, cfgs[0])
    jax_samplers.sample(b, cfgs[1])
    assert _examples(a.train) == _examples(b.train)


@pytest.mark.parametrize("save_examples", [False, True])
@pytest.mark.parametrize("kind", ["text", "image"])
def test_feature_record_save_matches_jax(tmp_path, kind, save_examples):
    rng = np.random.default_rng(0)
    recs = []
    for feats in (features, jax_features):
        r = feats.FeatureRecord(feats.Feature("layers.3", 11))
        if kind == "text":
            r.examples = [feats.Example(np.arange(4), np.float32([0.5, 1, 0, 2]))]
        else:
            im = Image.fromarray(np.random.default_rng(1).integers(0, 256, size=(6, 6, 3), dtype=np.uint8))
            r.examples = feats.prepare_image_examples(np.zeros((1, 20)), [np.linspace(0, 1, 20)], [im],
                                                      num_image_tokens=16)
        r.train = r.examples[:1]
        r.explanation = "a feature"
        r.score = np.float32(0.25)
        r.count = np.int64(3)
        recs.append(r)
    for r, name in zip(recs, ("port", "jax")):
        (tmp_path / name).mkdir()
        r.save(str(tmp_path / name), save_examples=save_examples)
    got = (tmp_path / "port" / "layers.3_feature11.json").read_bytes()
    assert got == (tmp_path / "jax" / "layers.3_feature11.json").read_bytes()
    assert (b"__pil_png_b64__" in got) == (kind == "image" and save_examples)
    with pytest.raises(TypeError, match="not JSON serializable"):
        features._json_default(object())
    assert recs[0].max_activation == recs[1].max_activation
    assert hash(recs[0].examples[0]) == hash(recs[1].examples[0]) and recs[0].examples[0] == recs[1].examples[0]
