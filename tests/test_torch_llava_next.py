"""The port's LLaVA-NeXT subject (multimodal_sae_tpu_torch/models/llava_next.py)
against the JAX package's: the anyres geometry, preprocessing, packing and
projection, `prepare_inputs`, capture on uniform and mixed-geometry
(right-padded) batches, and the checkpoint loaders, on the tiny model of
tests/torch_llava_tiny.py (weights drawn with numpy, carried by
`convert.py`) and at the real CLIP-L/336 geometry where only host arithmetic
or packing runs.

Tolerances: geometry, preprocessed pixels and packing are exact (integer
arithmetic, the same float32 numpy ops, and copies of integer-valued
features).  The projection and the captures run at fp32 on both sides with
the same ops in another summation order: within 1e-5 of the JAX values
relative to their largest magnitude (three tower layers, the projector,
three text layers).
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models import llava_next as jln
from multimodal_sae_tpu_torch.convert import llava_params_from_jax, llava_params_to_jax
from multimodal_sae_tpu_torch.models import llava_next as ln

from torch_llava_tiny import BOS, IMG_TOKEN, hf_config, images, models, numpy_state_dict

FP32_REL = 1e-5
HOOKS = ["model.layers.1", "layers.2"]


def _close(got: torch.Tensor, ref, rel=FP32_REL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    return models(seed=0)


# ---- geometry ---------------------------------------------------------------

SIDES = (1, 17, 32, 50, 64, 100, 300, 336, 480, 500, 640, 672, 900, 1000, 1008, 1500, 3000)


@pytest.mark.parametrize("which", ["llama3-llava-next-8b", "tiny"])
def test_geometry_matches_jax_exactly(which):
    if which == "tiny":
        cfg, jcfg = (m.LlavaNextConfig.from_hf(hf_config().to_dict()) for m in (ln, jln))
    else:
        cfg, jcfg = ln.LlavaNextConfig(), jln.LlavaNextConfig()
        assert cfg.image_grid_pinpoints == jcfg.image_grid_pinpoints == tuple(map(tuple, ln.DEFAULT_PINPOINTS))
    pins, S, p = cfg.image_grid_pinpoints, cfg.vision_config.image_size, cfg.vision_config.patch_size
    for h, w in itertools.product(SIDES, SIDES):
        assert ln.select_best_resolution((h, w), pins) == jln.select_best_resolution((h, w), pins)
        assert ln.get_anyres_image_grid_shape((h, w), pins, S) == jln.get_anyres_image_grid_shape((h, w), pins, S)
        assert ln.image_size_to_num_patches((h, w), pins, S) == jln.image_size_to_num_patches((h, w), pins, S)
        assert ln.get_number_of_features(h, w, cfg) == jln.get_number_of_features(h, w, jcfg)
        for ph, pw in pins:
            grid = (ph // S * (S // p), pw // S * (S // p))
            assert ln._unpadded_hw(h, w, *grid) == jln._unpadded_hw(h, w, *grid)


def test_token_counts_of_the_chip_geometries():
    """The four geometries chip_smoke.py drives: image tokens plus the BOS."""
    cfg = ln.LlavaNextConfig()
    counts = {hw: 1 + ln.get_number_of_features(*hw, cfg) for hw in ((480, 640), (336, 336), (300, 900), (1000, 1000))}
    assert counts == {(480, 640): 2341, (336, 336): 1177, (300, 900): 2329, (1000, 1000): 2929}
    assert ln.image_size_to_num_patches((480, 640), cfg.image_grid_pinpoints, 336) == 5


# ---- preprocessing ------------------------------------------------------------


@pytest.mark.parametrize("which", ["llama3-llava-next-8b", "tiny"])
def test_preprocess_anyres_is_bit_equal(which):
    if which == "tiny":
        cfg, jcfg = (m.LlavaNextConfig.from_hf(hf_config().to_dict()) for m in (ln, jln))
        sizes = [(50, 70), (90, 40), (64, 64), (20, 100), (33, 31)]
    else:
        cfg, jcfg = ln.LlavaNextConfig(), jln.LlavaNextConfig()
        sizes = [(480, 640), (300, 900), (336, 336)]
    for img in images(sizes, seed=1):
        got, size = ln.preprocess_anyres(img, cfg)
        ref, ref_size = jln.preprocess_anyres(img, jcfg)
        assert size == ref_size and got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


# ---- packing and projection ---------------------------------------------------


def _pack_cases(cfg):
    """(size, n_patches) for every pinpoint: an exact fit, a wide image
    (padding along the height) and a tall one (along the width)."""
    out = []
    for ph, pw in cfg.image_grid_pinpoints:
        for h, w in ((ph, pw), (ph // 2, pw), (ph, pw // 2), (ph - 37, pw), (ph, pw - 41)):
            out.append(((h, w), ln.image_size_to_num_patches((h, w), cfg.image_grid_pinpoints, cfg.vision_config.image_size)))
    return out


def test_pack_image_features_is_exact():
    """At the real geometry (24 x 24 tokens a tile), integer-valued fp32
    features land on the same token positions as in the JAX package, for
    every pinpoint, both padding axes and the base-only case."""
    cfg, jcfg = ln.LlavaNextConfig(), jln.LlavaNextConfig()
    T, D = cfg.vision_config.num_patches, 6
    rng = np.random.default_rng(2)
    axes = set()
    newline = rng.integers(-50, 50, size=D).astype(np.float32)
    for size, n_patches in _pack_cases(cfg) + [((336, 336), 1)]:
        feats = rng.integers(-1000, 1000, size=(n_patches, T, D)).astype(np.float32)
        ref = np.asarray(jln.pack_image_features(jnp.asarray(feats), jnp.asarray(newline), jcfg, size))
        got = ln.pack_image_features(torch.from_numpy(feats), torch.from_numpy(newline), cfg, size)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert ref.shape[0] == (ln.get_number_of_features(*size, cfg) if n_patches > 1 else T + 1)
        if n_patches > 1:
            nph, npw = ln.get_anyres_image_grid_shape(size, cfg.image_grid_pinpoints, 336)
            cur_h, cur_w, _ = ln._unpadded_hw(*size, nph * 24, npw * 24)
            axes.add("height" if cur_h < nph * 24 else "width" if cur_w < npw * 24 else "none")
        # One batched call over a group equals the per-image calls.
        group = np.stack([feats, feats[:, ::-1].copy()])
        batched = ln._pack_group(torch.from_numpy(group), torch.from_numpy(newline), cfg, size)
        assert torch.equal(batched[0], got)
        assert torch.equal(batched[1], ln.pack_image_features(torch.from_numpy(group[1]), torch.from_numpy(newline), cfg, size))
    assert axes == {"height", "width", "none"}


def test_project_image_features_matches_jax(pair):
    jmodel, model = pair
    pv = np.random.default_rng(3).standard_normal((5, 3, 32, 32)).astype(np.float32)
    ref = jln.project_image_features(jmodel.params, jmodel.cfg, jnp.asarray(pv))
    _close(ln.project_image_features(model.params, model.cfg, torch.from_numpy(pv)), ref)


# ---- prepare_inputs ---------------------------------------------------------------


def test_prepare_inputs_matches_jax(pair, monkeypatch):
    jmodel, model = pair
    imgs = images([(50, 70), (90, 40), (64, 64)], seed=4)
    imgs.append(imgs[0])  # a repeated image object shares one array
    prompts = [[BOS, IMG_TOKEN], [BOS, 5, IMG_TOKEN, 7], [IMG_TOKEN], [BOS, IMG_TOKEN, 9]]
    for workers in ("1", "4"):
        monkeypatch.setenv("MMSAE_PREP_WORKERS", workers)
        got = model.prepare_inputs(images=imgs, prompt_ids=prompts)
        ref = jmodel.prepare_inputs(images=imgs, prompt_ids=prompts)
        np.testing.assert_array_equal(got["input_ids"], ref["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"], ref["attention_mask"])
        assert got["image_sizes"] == ref["image_sizes"]
        for a, b in zip(got["pixel_values"], ref["pixel_values"]):
            np.testing.assert_array_equal(a, b)
        assert got["pixel_values"][0] is got["pixel_values"][3]
        assert (got["attention_mask"][:, -1] == 0).any()  # mixed geometries: right-padded


def test_prepare_inputs_text_only_and_mismatch(pair):
    jmodel, model = pair
    rows = [[1, 2, 3], [4, 5]]
    got, ref = model.prepare_inputs(prompt_ids=rows), jmodel.prepare_inputs(prompt_ids=rows)
    assert got.keys() == ref.keys() == {"input_ids", "attention_mask"}
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(model.prepare_inputs(input_ids=[[1, 2], [3, 4]])["input_ids"], [[1, 2], [3, 4]])
    with pytest.raises(ValueError, match="one image per row"):
        model.prepare_inputs(images=images([(40, 40)]), prompt_ids=[[BOS, IMG_TOKEN], [BOS, IMG_TOKEN]])


# ---- capture ------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("geometry", ["uniform", "mixed"])
def test_capture_matches_jax(flash, geometry):
    jmodel, model = models(seed=0, flash=flash)
    sizes = [(50, 70), (40, 60), (45, 66)] if geometry == "uniform" else [(50, 70), (90, 40), (64, 64)]
    imgs = images(sizes, seed=5)
    prompts = [[BOS, IMG_TOKEN, 11, 12], [BOS, 13, IMG_TOKEN, 14], [BOS, IMG_TOKEN, 15, 16]]
    batch = model.prepare_inputs(images=imgs, prompt_ids=prompts)
    padded = not batch["attention_mask"].all()
    assert padded == (geometry == "mixed")
    got = model.capture(batch, HOOKS)
    ref = jmodel.capture(jmodel.prepare_inputs(images=imgs, prompt_ids=prompts), HOOKS)
    assert list(got) == HOOKS  # the caller's spelling comes back
    for hook in HOOKS:
        _close(got[hook], ref[hook])
    out = model.forward(batch, capture=["model.layers.0"])
    jout = jmodel.forward(batch, capture=["model.layers.0"])
    _close(out["logits"], jout["logits"])
    _close(out["captured"]["model.layers.0"], jout["captured"]["model.layers.0"])


def test_capture_of_stacked_pixels_and_text_only(pair):
    """pixel_values as one stacked array (a collated batch) give the same
    captures; a batch with an empty pixel list is text."""
    jmodel, model = pair
    img = images([(50, 70)], seed=6)[0]
    prepared = model.prepare_inputs(images=[img, img], prompt_ids=[[BOS, IMG_TOKEN, 2]] * 2)
    ref = model.capture(prepared, ["layers.2"])["layers.2"]
    stacked = dict(prepared, pixel_values=np.stack(prepared["pixel_values"]))
    assert torch.equal(model.capture(stacked, ["layers.2"])["layers.2"], ref)
    text = {"input_ids": np.array([[1, 2, 3]]), "pixel_values": []}
    _close(model.capture(text, ["layers.1"])["layers.1"], jmodel.capture(text, ["layers.1"])["layers.1"])


def test_maybe_prepare_strips_padding_and_generate_raises(pair):
    jmodel, model = pair
    img = images([(50, 70)], seed=7)[0]
    prompt = [BOS, IMG_TOKEN, 7, 8]
    raw = {"input_ids": np.array([prompt]), "images": [img]}
    padded = {"input_ids": np.array([prompt + [0, 0, 0]]), "attention_mask": np.array([[1, 1, 1, 1, 0, 0, 0]]),
              "images": [img]}
    got = model.capture(padded, ["model.layers.1"])["model.layers.1"]
    assert torch.equal(got, model.capture(raw, ["model.layers.1"])["model.layers.1"])
    _close(got, jmodel.capture(padded, ["model.layers.1"])["model.layers.1"])
    assert model._maybe_prepare({"input_ids": np.array([[1, 2]]), "image": [None]}).keys() == {"input_ids"}
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1, steering and generation"):
        model.generate(model.prepare_inputs(images=[img], prompt_ids=[prompt]))


def test_placeholder_count_mismatch_raises(pair):
    _, model = pair
    batch = model.prepare_inputs(images=images([(50, 70)]), prompt_ids=[[BOS, IMG_TOKEN]])
    batch["input_ids"] = batch["input_ids"][:, :-1]
    batch["attention_mask"] = batch["attention_mask"][:, :-1]
    with pytest.raises(ValueError, match="placeholder tokens"):
        model.capture(batch, ["layers.0"])


def test_hookpoint_surface(pair):
    _, model = pair
    assert model.hookpoint_names() == ["model.layers.0", "model.layers.1", "model.layers.2"]
    assert model.layers_name() == "model.layers"
    assert model.resolve_widths(["model.layers.1"]) == {"model.layers.1": 64}


def test_random_model_runs_on_the_cpu():
    cfg = ln.LlavaNextConfig.from_hf(hf_config().to_dict())
    model = ln.LlavaNextModel.random(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = model.prepare_inputs(images=images([(50, 70), (90, 40)]), prompt_ids=[[BOS, IMG_TOKEN]] * 2)
    h = model.capture(batch, ["model.layers.2"])["model.layers.2"]
    assert h.shape == (2, batch["input_ids"].shape[1], 64) and torch.isfinite(h).all()


# ---- loaders and conversion ----------------------------------------------------


def _checkpoint(d, old_layout):
    from safetensors.torch import save_file

    hf_cfg = hf_config()
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    save_file(numpy_state_dict(hf_cfg, seed=8, old_layout=old_layout), str(d / "model.safetensors"))
    return str(d)


@pytest.mark.parametrize("old_layout", [False, True], ids=["post-4.52 keys", "pre-4.52 keys"])
def test_load_llava_next_matches_jax(tmp_path, old_layout):
    path = _checkpoint(tmp_path / "ckpt", old_layout)
    jparams, jcfg = jln.load_llava_next(path, dtype=jnp.float32)
    params, cfg = ln.load_llava_next(path, device="cpu")
    carried = llava_params_from_jax(jparams, device="cpu")
    flat = lambda tree, pre="": {  # noqa: E731
        k2: v2 for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree))
        for k2, v2 in (flat(v, f"{pre}{k}.").items() if isinstance(v, (dict, list)) else [(f"{pre}{k}", v)])
    }
    got, ref = flat(params), flat(carried)
    assert got.keys() == ref.keys() and "language_model.lm_head" in got
    assert all(torch.equal(got[k], ref[k]) for k in got)
    back, jflat = flat(llava_params_to_jax(params)), flat(jparams)
    assert back.keys() == jflat.keys()
    assert all(np.array_equal(back[k], np.asarray(jflat[k])) for k in back)
    assert cfg.text_config.num_hidden_layers == jcfg.text_config.num_hidden_layers == 3

    # --truncate_layers: only two layers reach the device; layers.1 is unchanged.
    short, short_cfg = ln.load_llava_next(path, device="cpu", truncate_layers=2)
    assert len(short["language_model"]["layers"]) == short_cfg.text_config.num_hidden_layers == 2
    img = images([(50, 70)], seed=9)
    full, cut = ln.LlavaNextModel(params, cfg), ln.LlavaNextModel(short, short_cfg)
    batch = full.prepare_inputs(images=img, prompt_ids=[[BOS, IMG_TOKEN]])
    assert torch.equal(full.capture(batch, ["layers.1"])["layers.1"], cut.capture(batch, ["layers.1"])["layers.1"])
    with pytest.raises(ValueError, match="exceeds"):
        ln.load_llava_next(path, device="cpu", truncate_layers=4)


def test_state_dict_loader_finds_the_head_beside_the_decoder():
    hf_cfg = hf_config()
    cfg = ln.LlavaNextConfig.from_hf(hf_cfg.to_dict())
    sd = numpy_state_dict(hf_cfg, seed=10, old_layout=True)
    params = ln.llava_params_from_state_dict(sd, cfg, torch.device("cpu"))
    assert torch.equal(params["language_model"]["lm_head"], sd["language_model.lm_head.weight"])
    assert torch.equal(params["image_newline"], sd["image_newline"])
    del sd["language_model.lm_head.weight"]
    with pytest.raises(KeyError, match="lm_head"):
        ln.llava_params_from_state_dict(sd, cfg, torch.device("cpu"))
    tied = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, tie_word_embeddings=True))
    assert "lm_head" not in ln.llava_params_from_state_dict(sd, tied, torch.device("cpu"))["language_model"]
