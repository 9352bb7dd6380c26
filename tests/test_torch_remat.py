"""`--remat` (`LlamaConfig.remat`): the subject's decoder layers recomputed
in the backward through non-reentrant `torch.utils.checkpoint`, against the
same subject without it and against the JAX package's `remat=True`
(`jax.checkpoint` around each decoder layer).

Subjects: the tiny LLaMA of tests/torch_llama_tiny.py and the tiny
LLaVA-NeXT of tests/torch_llava_tiny.py (fp32, numpy-drawn, carried by
`convert.py`), SAEs of 64 latents at k = 4 drawn by the JAX package,
inputs numpy-seeded.

* The port with `remat` equals the port without it bit for bit: fast text
  attribution (eager and flash attention, a left-padded batch), LLaVA fast
  attribution (a ragged two-geometry batch), general attribution over two
  hookpoints, the int8 subject (W8A16 and W8A8 products), the `--dp 2`
  replicas, and `--tp 2` on two gloo ranks (tests/torch_mp_drivers/
  mp_tp.py).  The recompute runs the same operations on the same inputs,
  so nothing may move.
* Against the JAX package with `remat=True`: rtol 1e-4, atol 1e-6, the
  tolerance tests/test_torch_attribution*.py hold the two packages to
  (fp32 on both sides, other summation orders).
* The layers are recomputed: `decoder_layer` runs twice a layer over a
  forward and its backward, and the tape keeps none of a layer's
  activations (no fp32 score tensor), only what lies outside the layers.
* A forward without autograd (capture) and the cached path (generation)
  are never wrapped; `load_subject_model(remat=True)` sets the flag on the
  LLaMA and the LLaVA branch.
"""

import dataclasses
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
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, sae_params_from_jax
from multimodal_sae_tpu_torch.features.patching import fast_attribution_maps, general_attribution_maps, get_logit_diff
from multimodal_sae_tpu_torch.models import llama
from multimodal_sae_tpu_torch.sae import Sae

import torch_llama_tiny
import torch_llava_tiny
from torch_mp import start_ranks, wait_all

TOL = dict(rtol=1e-4, atol=1e-6)
ANSWERS = np.array([[3, 4], [5, 6]])


def with_remat(model):
    """The same subject (either package, LLaMA or LLaVA-NeXT; its
    parameters shared) with `remat` set on its language model."""
    cfg = model.cfg
    if hasattr(cfg, "text_config"):
        cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, remat=True))
    else:
        cfg = dataclasses.replace(cfg, remat=True)
    return type(model)(model.params, cfg)


def _sae_pair(seed=1):
    jsae = JaxSae(64, JaxSaeConfig(num_latents=64, k=4), key=jax.random.PRNGKey(seed))
    params = sae_params_from_jax({name: np.asarray(a) for name, a in jsae.params.items()}, device="cpu")
    return jsae, Sae(64, SaeConfig(num_latents=64, k=4), params=params)


def _metrics(rows):
    answers = ANSWERS[:rows]
    return (partial(jax_get_logit_diff, answer_token_indices=jnp.asarray(answers)),
            partial(get_logit_diff, answer_token_indices=torch.as_tensor(answers)))


def _text_batch():
    ids = np.random.default_rng(0).integers(1, 256, size=(2, 20))
    mask = np.ones_like(ids)
    mask[1, :6] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _indices(model, hook, sae, batch):
    """Four features inside some token's top-k and two outside every one."""
    h = model.capture(batch, [hook])[hook]
    inside = sorted({int(i) for i in sae.encode(h.reshape(-1, 64)).top_indices.reshape(-1)})
    return inside[:4] + [f for f in range(64) if f not in inside][:2]


def _assert_bits_and_jax(plain, remat, ref):
    assert len(plain) == len(remat) == len(ref) == 6 and any(p.any() for p in plain)
    for f, (p, r, j) in enumerate(zip(plain, remat, ref)):
        np.testing.assert_array_equal(r, p, err_msg=f"feature {f}: remat against no remat")
        np.testing.assert_allclose(r, np.asarray(j), **TOL, err_msg=f"feature {f}: against JAX remat=True")


@pytest.fixture(scope="module")
def sae_pair():
    return _sae_pair()


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_fast_text_attribution(sae_pair, flash):
    jmodel, model = torch_llama_tiny.models(seed=0, flash=flash)
    jsae, sae = sae_pair
    batch = _text_batch()
    jmetric, metric = _metrics(2)
    indices = _indices(model, "layers.1", sae, batch)
    run = partial(fast_attribution_maps, hook="layers.1", sae=sae, batch=batch, metric=metric, indices=indices,
                  feature_batch=4, progress=False)
    plain, remat = run(model)["layers.1"], run(with_remat(model))["layers.1"]
    ref = JA.fast_attribution_maps(with_remat(jmodel), "layers.1", jsae, batch, jmetric, indices, feature_batch=4,
                                   progress=False)["layers.1"]
    _assert_bits_and_jax(plain, remat, ref)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_llava_fast_attribution(sae_pair, flash):
    from multimodal_sae_tpu_torch.models.llava_next import repack_left_padded

    jmodel, model = torch_llava_tiny.models(seed=0, flash=flash)
    jsae, sae = sae_pair
    hook = "model.layers.1"
    B = torch_llava_tiny.BOS
    batch = repack_left_padded(model.prepare_inputs(
        images=torch_llava_tiny.images([(50, 70), (90, 40)], seed=3),
        prompt_ids=[[B, torch_llava_tiny.IMG_TOKEN, 11, 12], [B, 13, torch_llava_tiny.IMG_TOKEN, 14, 15, 16]]))
    assert not np.asarray(batch["attention_mask"]).all()
    jmetric, metric = _metrics(2)
    indices = _indices(model, hook, sae, batch)
    run = partial(fast_attribution_maps, hook=hook, sae=sae, batch=batch, metric=metric, indices=indices,
                  feature_batch=3, progress=False)
    plain, remat = run(model)[hook], run(with_remat(model))[hook]
    ref = JA.fast_attribution_maps(with_remat(jmodel), hook, jsae, batch, jmetric, indices, feature_batch=3,
                                   progress=False)[hook]
    _assert_bits_and_jax(plain, remat, ref)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_general_attribution_over_two_hookpoints(flash):
    """The gradient at layers.0's splice runs back through layers.1's and
    through the recomputed layers between them."""
    jmodel, model = torch_llama_tiny.models(seed=0, flash=flash)
    hooks = ("layers.0", "layers.1")
    pairs = {hook: _sae_pair(seed) for seed, hook in enumerate(hooks, start=1)}
    saes = {hook: pair[1] for hook, pair in pairs.items()}
    batch = _text_batch()
    jmetric, metric = _metrics(2)
    indices = _indices(model, "layers.1", saes["layers.1"], batch)
    plain = general_attribution_maps(model, saes, batch, metric, indices, progress=False)
    remat = general_attribution_maps(with_remat(model), saes, batch, metric, indices, progress=False)
    att = object.__new__(JA.Attribution)  # its __init__ opens images
    att.model, att.sae_dict = with_remat(jmodel), {hook: pair[0] for hook, pair in pairs.items()}
    att.data, att.batch, att.feature_batch, att.metric = [None] * 2, batch, 4, jmetric
    ref = att.get_attribution(indices=indices)
    for hook in hooks:
        _assert_bits_and_jax(plain[hook], remat[hook], ref[hook])


@pytest.mark.parametrize("int8", [False, True], ids=["w8a16", "w8a8"])
def test_int8_subject(sae_pair, int8):
    """The quantised products' straight-through backward, recomputed."""
    from multimodal_sae_tpu_torch.models.quant import is_quantized, quantize_llama_params

    params = llama_params_from_jax(torch_llama_tiny.numpy_params(0), device="cpu")
    quantize_llama_params(params, device="cpu")
    assert is_quantized(params["layers"][2]["down_proj"])
    model = llama.LlamaModel(params, llama.LlamaConfig(**torch_llama_tiny.TINY, flash_attention=True,
                                                       int8_matmul=int8))
    _, sae = sae_pair
    batch = _text_batch()
    indices = _indices(model, "layers.1", sae, batch)
    run = partial(fast_attribution_maps, hook="layers.1", sae=sae, batch=batch, metric=_metrics(2)[1],
                  indices=indices, feature_batch=3, progress=False)
    plain, remat = run(model)["layers.1"], run(with_remat(model))["layers.1"]
    assert any(p.any() for p in plain)
    for p, r in zip(plain, remat):
        np.testing.assert_array_equal(r, p)


def _counting(monkeypatch, name):
    calls = []
    real = getattr(llama, name)

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kw)

    monkeypatch.setattr(llama, name, counted)
    return calls


def _suffix_gradient(model, hidden):
    """The gradient of a logit sum at `hidden`, entering layer 1."""
    x = hidden.clone().requires_grad_(True)
    logits = llama.forward_from_layer_above(model.params, model.cfg, x, 0, last_logit_only=False)
    return logits, x


def test_layers_run_twice_under_remat(monkeypatch):
    _, model = torch_llama_tiny.models(seed=0)
    hidden = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 64)).astype(np.float32))
    calls = _counting(monkeypatch, "decoder_layer")
    grads = {}
    for tag, m in (("plain", model), ("remat", with_remat(model))):
        calls.clear()
        logits, x = _suffix_gradient(m, hidden)
        forward = len(calls)
        logits.square().sum().backward()
        grads[tag] = x.grad
        # Layers 1 and 2 above layers.0: once each forward; under remat once
        # more each in the backward, with autograd on.
        assert (forward, len(calls)) == ((2, 2) if tag == "plain" else (2, 4)), tag
        assert calls[forward:] == [True] * (len(calls) - forward)
    assert torch.equal(grads["plain"], grads["remat"])


def test_tape_keeps_no_layer_activation():
    """The tensors autograd saves for the backward of a forward over
    layers 1 and 2, eager attention: without remat every layer's fp32
    scores (2, kvH, n_rep * S, S) among them; with remat none of a layer's
    (the checkpoint keeps the layer inputs itself), only the final norm's
    and the LM head's."""
    _, model = torch_llama_tiny.models(seed=0)
    S = 12
    hidden = torch.from_numpy(np.random.default_rng(1).standard_normal((2, S, 64)).astype(np.float32))
    saved = {}
    for tag, m in (("plain", model), ("remat", with_remat(model))):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _suffix_gradient(m, hidden)
        saved[tag] = shapes
    scores = (2, 2, 2 * S, S)
    assert saved["plain"].count(scores) >= 2 and scores not in saved["remat"]
    nbytes = {tag: sum(int(np.prod(s)) * 4 for s in shapes) for tag, shapes in saved.items()}
    assert nbytes["remat"] * 4 < nbytes["plain"], nbytes


def test_capture_and_generation_are_not_wrapped(monkeypatch):
    _, model = torch_llama_tiny.models(seed=0, flash=True)
    remat = with_remat(model)
    calls = _counting(monkeypatch, "checkpoint")
    batch = _text_batch()
    assert torch.equal(remat.capture(batch, ["layers.2"])["layers.2"], model.capture(batch, ["layers.2"])["layers.2"])
    assert torch.equal(remat.generate(batch, max_new_tokens=4), model.generate(batch, max_new_tokens=4))
    assert calls == []
    hidden = torch.zeros(1, 4, 64)
    _suffix_gradient(remat, hidden)
    assert calls == [True, True]


def test_dp_replicas_carry_remat(sae_pair, monkeypatch):
    """`shard_subject_model_dp` copies the model shallowly: every replica
    shares its config, and each recomputes its share of the chunk."""
    from multimodal_sae_tpu_torch.parallel import shard_subject_model_dp

    _, sae = sae_pair
    batch = _text_batch()
    outs = {}
    calls = _counting(monkeypatch, "checkpoint")
    for tag in ("plain", "remat"):
        _, model = torch_llama_tiny.models(seed=0, flash=True)
        model = with_remat(model) if tag == "remat" else model
        _, replicas = shard_subject_model_dp(model, 2, devices=["cpu", "cpu"])
        assert [r.cfg.remat for r in replicas] == [tag == "remat"] * 2
        calls.clear()
        outs[tag] = fast_attribution_maps(model, "layers.1", sae, batch, _metrics(2)[1], [0, 5, 9, 17],
                                          feature_batch=4, progress=False)["layers.1"]
        assert len(calls) == (0 if tag == "plain" else 2 * 1)  # one chunk: layer 2 on each replica
    for p, r in zip(outs["plain"], outs["remat"]):
        np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("branch", ["llama", "llava"])
def test_load_subject_model_sets_remat(tmp_path, branch):
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model

    if branch == "llama":
        from torch_tp_tiny import write_checkpoint
    else:
        from torch_llava_tiny import write_checkpoint
    ckpt = write_checkpoint(tmp_path)
    for flag in (False, True):
        model, _, _ = load_subject_model(ckpt, dtype=torch.float32, device="cpu", remat=flag, flash_attention=True)
        text_cfg = model.cfg.text_config if branch == "llava" else model.cfg
        assert text_cfg.remat is flag and text_cfg.flash_attention


def test_tp2_with_remat_equals_tp2(tmp_path):
    """Two gloo ranks at --tp 2: the gradient at the embeddings (through
    every layer's two collectives, recomputed) and fast attribution equal
    bit for bit with and without remat, on both ranks; the recompute
    repeats the layers' all-reduces in one order on every rank (a
    mismatch would hang gloo, here bounded by the drivers' timeout)."""
    from torch_tp_tiny import write_checkpoint

    ckpt = write_checkpoint(tmp_path / "ckpt")
    Sae(64, SaeConfig(num_latents=128, k=8), seed=3, device="cpu").save_to_disk(tmp_path / "saes" / "layers.1")
    rng = np.random.default_rng(0)
    mask = np.ones((3, 10), np.int64)
    mask[1, 7:] = mask[2, 5:] = 0
    np.savez(tmp_path / "inputs.npz", ids=rng.integers(1, 255, size=(3, 10)), mask=mask,
             weights=rng.standard_normal((3, 10, 256)).astype(np.float32),
             attr_ids=rng.integers(1, 255, size=(2, 7)), answers=np.array([[3, 7], [11, 5]]),
             feats=np.array([0, 5, 9, 17, 40, 77, 100]))
    rcs, outs = wait_all(start_ranks("mp_tp.py", ["remat", ckpt, tmp_path / "inputs.npz", tmp_path / "saes",
                                                  tmp_path / "tp"]), timeout=200)
    if any(rcs):
        pytest.fail("\n".join(f"--- rank {i} (rc={rc}) ---\n{o[-3000:]}" for i, (rc, o) in enumerate(zip(rcs, outs))))
    r0, r1 = (dict(np.load(tmp_path / f"tp.rank{r}.npz")) for r in (0, 1))
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    assert np.abs(r0["plain_dx"]).max() > 1 and np.abs(r0["plain_sal"]).max() > 0.01
    np.testing.assert_array_equal(r0["remat_dx"], r0["plain_dx"])
    np.testing.assert_array_equal(r0["remat_sal"], r0["plain_sal"])
    # The recompute of a layer redoes its o_proj all-reduce; it stops (the
    # checkpoint's early stop) once down_proj has saved its input, before
    # down_proj's all-reduce.  One layer a recompute: the gradient's 3 and
    # attribution's 3 chunks of layer 2.  The LM head's gathers are not
    # recomputed.
    plain, remat = r0["plain_counts"], r0["remat_counts"]
    assert remat.tolist() == [plain[0] + 3 + 3, plain[1]], (plain, remat)
