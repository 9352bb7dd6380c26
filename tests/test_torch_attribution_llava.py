"""Fast attribution on the LLaVA-NeXT subject: the port's prefix/suffix path
(`fast_attribution_maps`, and `Attribution` with one SAE, which takes it
now that `LlavaNextModel` has `forward_from_layer`) against the JAX
package's fast path, against the port's own general path, and a ragged
batch of two anyres geometries against each row alone.

The subject is the tiny LLaVA of tests/torch_llava_tiny.py (numpy-drawn
fp32 weights, carried by `convert.py`), the SAE 64 latents at k = 4 over
the text width 64, the probe images random PIL images.  Tolerances:

* against the JAX fast path and against the port's general path: rtol
  1e-4, atol 1e-6, as tests/test_launch_integration.py holds the JAX fast
  path to its general one (fp32 on both sides, other summation orders);
* a row of the ragged batch against the row alone: the batch's metric is
  a mean over its rows, so the row's saliency times the row count, over
  its real positions, against the row alone, at rtol 1e-4, atol 1e-6.  The
  left padding shifts the row's RoPE positions, which moves nothing in
  exact arithmetic (attention sees only relative positions) and leaves
  fp32 rounding.  Its pad positions are exactly 0."""

import json
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.patching import attribution as JA
from multimodal_sae_tpu.features.patching.utils import get_logit_diff as jax_get_logit_diff
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.features.patching import attribution as A
from multimodal_sae_tpu_torch.features.patching import (
    Attribution,
    fast_attribution_maps,
    general_attribution_maps,
    get_logit_diff,
)
from multimodal_sae_tpu_torch.models import llava_next
from multimodal_sae_tpu_torch.models.llava_next import repack_left_padded
from multimodal_sae_tpu_torch.sae import Sae

from torch_llava_tiny import BOS, IMG_TOKEN, images, models

TOL = dict(rtol=1e-4, atol=1e-6)
HOOK = "model.layers.1"
SIZES = [(50, 70), (90, 40)]  # two anyres geometries: a ragged batch
PROMPTS = [[BOS, IMG_TOKEN, 11, 12], [BOS, 13, IMG_TOKEN, 14, 15, 16]]
ANSWERS = np.array([[3, 4], [5, 6]])


@pytest.fixture(scope="module", params=[False, True], ids=["eager", "flash"])
def pair(request):
    return models(seed=0, flash=request.param)


@pytest.fixture(scope="module")
def sae_pair():
    jsae = JaxSae(64, JaxSaeConfig(num_latents=64, k=4), key=jax.random.PRNGKey(1))
    params = sae_params_from_jax({name: np.asarray(a) for name, a in jsae.params.items()}, device="cpu")
    return jsae, Sae(64, SaeConfig(num_latents=64, k=4), params=params)


class Tok:
    """Characters to ids (2 + ord % 100, four a piece around each
    `<image>`) after a BOS; an answer's id from its first character."""

    def __call__(self, text, **kw):
        ids = [BOS]
        for part in text.split("<image>"):
            ids += [2 + ord(c) % 100 for c in part][:4]
            ids.append(IMG_TOKEN)
        ids.pop()
        return {"input_ids": ids}

    def convert_tokens_to_ids(self, tok):
        return 2 + ord(tok[0]) % 100


def _batch(model, rows):
    prepared = model.prepare_inputs(images=images([SIZES[r] for r in rows], seed=3),
                                    prompt_ids=[PROMPTS[r] for r in rows])
    batch = repack_left_padded(prepared)
    if np.asarray(batch["attention_mask"]).all():
        batch = {k: v for k, v in batch.items() if k != "attention_mask"}
    return batch


def _metrics(n_rows):
    answers = ANSWERS[:n_rows]
    return (partial(jax_get_logit_diff, answer_token_indices=jnp.asarray(answers)),
            partial(get_logit_diff, answer_token_indices=torch.as_tensor(answers)))


def _indices(model, sae, batch):
    """Three features inside some token's top-k and two outside every one."""
    h = model.capture(batch, [HOOK])[HOOK]
    inside = sorted({int(i) for i in sae.encode(h.reshape(-1, 64)).top_indices.reshape(-1)})
    return inside[:3] + [f for f in range(64) if f not in inside][:2]


@pytest.mark.parametrize("rows", [(0,), (0, 1)], ids=["one_row", "ragged"])
def test_fast_attribution_matches_jax(pair, sae_pair, rows):
    jmodel, model = pair
    jsae, sae = sae_pair
    batch = _batch(model, rows)
    jmetric, metric = _metrics(len(rows))
    indices = _indices(model, sae, batch)
    ref = JA.fast_attribution_maps(jmodel, HOOK, jsae, batch, jmetric, indices, feature_batch=2, progress=False)[HOOK]
    got = fast_attribution_maps(model, HOOK, sae, batch, metric, indices, feature_batch=2, progress=False)[HOOK]
    assert len(got) == len(ref) == 5
    for f, g, r in zip(indices, got, ref):
        assert g.shape == batch["input_ids"].shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"feature {f}", **TOL)
    assert any(g.any() for g in got[:3])
    assert not any(g.any() for g in got[3:])  # outside every top-k: exactly 0
    if "attention_mask" in batch:
        pads = ~np.asarray(batch["attention_mask"]).astype(bool)
        assert pads.any() and not any(g[pads].any() for g in got)


@pytest.mark.parametrize("rows", [(0,), (0, 1)], ids=["one_row", "ragged"])
def test_fast_path_matches_the_general_path(pair, sae_pair, rows):
    _, model = pair
    _, sae = sae_pair
    batch = _batch(model, rows)
    _, metric = _metrics(len(rows))
    indices = _indices(model, sae, batch)
    fast = fast_attribution_maps(model, HOOK, sae, batch, metric, indices, feature_batch=3, progress=False)[HOOK]
    general = general_attribution_maps(model, {HOOK: sae}, batch, metric, indices, progress=False)[HOOK]
    for f, g in zip(fast, general):
        np.testing.assert_allclose(f, g, **TOL)


def _probe(tmp_path, rows, name):
    """Probe images as PNG files and the probe json of `rows`."""
    items = []
    for r in rows:
        path = tmp_path / f"image{r}.png"
        if not path.exists():
            (img,) = images([SIZES[r]], seed=10 + r)
            img.save(path)
        items.append({"prompt": ["<image> is a", "<image> shows some"][r], "answer": "cat", "baseline": "dog",
                      "image": str(path)})
    out = tmp_path / f"{name}.json"
    out.write_text(json.dumps(items))
    return str(out)


@pytest.fixture()
def sae_dir(tmp_path, sae_pair):
    sae_pair[1].save_to_disk(tmp_path / "saes" / HOOK)
    return str(tmp_path / "saes")


def test_attribution_takes_the_fast_path_and_matches_jax(pair, sae_dir, tmp_path, monkeypatch):
    """`Attribution` with one SAE on a LLaVA subject takes the fast path
    (the general path is made to raise), runs the tower once per image
    geometry in the prefix and none in the suffix, and gives the JAX
    `Attribution`'s saliencies."""
    jmodel, model = pair
    data = _probe(tmp_path, (0, 1), "both")

    def refuse(*a, **kw):
        raise AssertionError("the general path ran")

    monkeypatch.setattr(A, "general_attribution_maps", refuse)
    tower = []
    real_tower = llava_next.project_image_features

    def counted_tower(params, cfg, pixel_values):
        tower.append(pixel_values.shape[0])
        return real_tower(params, cfg, pixel_values)

    monkeypatch.setattr(llava_next, "project_image_features", counted_tower)
    port = Attribution(model, Tok(), sae_path=sae_dir, data_path=data, selected_sae=HOOK, feature_batch=2,
                       device="cpu")
    ref_attr = JA.Attribution(jmodel, Tok(), sae_path=sae_dir, data_path=data, selected_sae=HOOK, feature_batch=2)
    np.testing.assert_array_equal(port.batch["input_ids"], ref_attr.batch["input_ids"])
    np.testing.assert_array_equal(port.answer_ids, ref_attr.answer_ids)
    indices = _indices(model, port.sae_dict[HOOK], port.batch)
    tower.clear()
    got = port.get_attribution(indices=indices)[HOOK]
    assert len(tower) == 2  # one call per geometry, in the prefix only
    ref = ref_attr.get_attribution(indices=indices)[HOOK]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)


def test_ragged_batch_matches_each_row_alone(pair, sae_dir, tmp_path):
    _, model = pair
    both = Attribution(model, Tok(), sae_path=sae_dir, data_path=_probe(tmp_path, (0, 1), "both"),
                       selected_sae=HOOK, device="cpu")
    am = np.asarray(both.batch["attention_mask"])
    assert (am[:, -1] == 1).all() and (am == 0).any()  # left-padded and ragged
    indices = _indices(model, both.sae_dict[HOOK], both.batch)
    out = both.get_attribution(indices=indices)[HOOK]
    for r in (0, 1):
        alone = Attribution(model, Tok(), sae_path=sae_dir, data_path=_probe(tmp_path, (r,), f"row{r}"),
                            selected_sae=HOOK, device="cpu")
        ref = alone.get_attribution(indices=indices)[HOOK]
        L = ref[0].shape[1]
        assert am[r].sum() == L
        for f, g, one in zip(indices, out, ref):
            np.testing.assert_allclose(g[r, -L:] * 2, one[0], err_msg=f"row {r}, feature {f}", **TOL)
            assert not g[r, :-L].any()
