"""Generation in the PyTorch port against the JAX package, on the CPU: the
KV-cached prefill and decode steps of `llama_forward`, `greedy_generate`
(greedy, EOS, interventions, sampling), `top_p_filter`, and
`LlavaNextModel.generate`.

The subjects: the tiny LLaMA of tests/torch_llama_tiny.py (3 layers,
hidden 64, 4 heads, 2 kv heads, vocab 256, fp32, drawn with numpy and
carried by `convert.llama_params_from_jax`), and the tiny LLaVA-NeXT of
tests/torch_llava_tiny.py.  Tolerances: fp32 logits and cache entries
within 1e-5 (the two sides sum fp32 products in their own orders, about
1e-6 apart); token ids and top-p masks exactly.  Greedy tokens are compared
up to the first step at which the JAX side's top-2 logit gap (read from a
cache-free JAX forward over the generated sequence) falls under NEAR_TIE,
and at least MIN_STEPS steps must be compared."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.models import llama as jl
from multimodal_sae_tpu_torch.models import llama as pl
from torch_llama_tiny import TINY, models

transformers = pytest.importorskip("transformers")

ATOL = 1e-5
NEAR_TIE = 1e-4
MIN_STEPS = 8
NEW = 12
S = 10
LEFT_PADS = (0, 2, 5)


@pytest.fixture(scope="module")
def subject():
    """(JAX params, port params) of the tiny LLaMA."""
    jmodel, model = models()
    return jmodel.params, model.params


def _cfgs(flash):
    return jl.LlamaConfig(**TINY, flash_attention=flash), pl.LlamaConfig(**TINY, flash_attention=flash)


def _prompt(padded, seed=1):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], size=(len(LEFT_PADS), S))
    if not padded:
        return ids, None
    mask = np.ones_like(ids)
    for row, pad in enumerate(LEFT_PADS):
        mask[row, :pad] = 0
    return ids, mask


def _positions(mask):
    return np.maximum(np.cumsum(mask, axis=1) - 1, 0)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left-padded-0-2-5"])
def test_cached_prefill_matches_jax(subject, flash, padded):
    """Last-position logits and the cache's first S slots of k and v after
    the prefill, against JAX `llama_forward(..., cache=KVCache.init(...))`.
    The JAX prefill runs eager attention over the whole cache; the port's
    runs K3's plain version over the prompt's keys under `flash`.  A pad
    query has no valid key, and the two attentions give it different (and
    never read) outputs, so from layer 1 on the pad slots are compared only
    with eager attention on both sides; layer 0's pad slots depend on the
    embeddings alone and are compared always."""
    jparams, params = subject
    jcfg, cfg = _cfgs(flash)
    ids, mask = _prompt(padded)
    B, max_len = ids.shape[0], S + NEW
    full = None if mask is None else np.concatenate([mask, np.ones((B, NEW), np.int64)], axis=1)
    pos = None if mask is None else _positions(mask)
    ref = jl.llama_forward(
        jparams, jcfg, jnp.asarray(ids), attention_mask=None if full is None else jnp.asarray(full),
        position_ids=None if pos is None else jnp.asarray(pos), cache=jl.KVCache.init(jcfg, B, max_len),
    )
    got = pl.llama_forward(
        params, cfg, torch.as_tensor(ids), attention_mask=None if full is None else torch.as_tensor(full),
        position_ids=None if pos is None else torch.as_tensor(pos), cache=pl.KVCache.init(cfg, B, max_len, device="cpu"),
    )
    assert got["cache"].length == S and int(ref["cache"].length) == S
    np.testing.assert_allclose(got["logits"][:, -1].numpy(), np.asarray(ref["logits"])[:, -1], atol=ATOL, rtol=0)
    real = np.ones((B, S), bool) if mask is None else mask.astype(bool)
    for name in ("k", "v"):
        want = np.asarray(getattr(ref["cache"], name))
        have = getattr(got["cache"], name).numpy()
        assert have.shape == want.shape == (3, B, 2, max_len, 16)
        np.testing.assert_array_equal(have[:, :, :, S:], 0)
        np.testing.assert_allclose(have[0, :, :, :S], want[0, :, :, :S], atol=ATOL, rtol=0)
        for b in range(B):
            cols = slice(None) if not flash else real[b]
            np.testing.assert_allclose(have[:, b, :, :S][:, :, cols], want[:, b, :, :S][:, :, cols],
                                       atol=ATOL, rtol=0, err_msg=f"{name}, row {b}")


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left-padded-0-2-5"])
def test_teacher_forced_decode_steps_match_jax(subject, flash, padded):
    """Decode-step logits at every one of NEW steps, each side feeding the
    same ids through its own cache (full-cache mask, positions real length +
    step - 1, as `greedy_generate` passes them)."""
    jparams, params = subject
    jcfg, cfg = _cfgs(flash)
    ids, mask = _prompt(padded)
    B = ids.shape[0]
    fed = np.random.default_rng(2).integers(0, TINY["vocab_size"], size=(B, NEW))
    m = np.ones_like(ids) if mask is None else mask
    full = np.concatenate([m, np.ones((B, NEW), np.int64)], axis=1)
    jcache = jl.llama_forward(jparams, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(full),
                              position_ids=jnp.asarray(_positions(m)), cache=jl.KVCache.init(jcfg, B, S + NEW))["cache"]
    cache = pl.llama_forward(params, cfg, torch.as_tensor(ids), attention_mask=torch.as_tensor(full),
                             position_ids=torch.as_tensor(_positions(m)),
                             cache=pl.KVCache.init(cfg, B, S + NEW, device="cpu"))["cache"]
    lengths = m.sum(axis=1)
    for i in range(NEW):
        pos = (lengths + i)[:, None]
        ref = jl.llama_forward(jparams, jcfg, jnp.asarray(fed[:, i:i + 1]), attention_mask=jnp.asarray(full),
                               position_ids=jnp.asarray(pos), cache=jcache)
        got = pl.llama_forward(params, cfg, torch.as_tensor(fed[:, i:i + 1]), attention_mask=torch.as_tensor(full),
                               position_ids=torch.as_tensor(pos), cache=cache)
        jcache, cache = ref["cache"], got["cache"]
        np.testing.assert_allclose(got["logits"][:, -1].numpy(), np.asarray(ref["logits"])[:, -1],
                                   atol=ATOL, rtol=0, err_msg=f"step {i}")
    assert cache.length == S + NEW


def test_block_mask_and_cache_overflow(subject):
    """A mask over only the block is placed at the block's offset (equal to
    the full-cache mask); a mask of another length, and a block past the
    cache's end, raise."""
    _, params = subject
    _, cfg = _cfgs(False)
    ids, mask = _prompt(True)
    B = ids.shape[0]
    full = torch.as_tensor(np.concatenate([mask, np.ones((B, 4), np.int64)], axis=1))
    pos = torch.as_tensor(_positions(mask))
    a = pl.llama_forward(params, cfg, torch.as_tensor(ids), attention_mask=full, position_ids=pos,
                         cache=pl.KVCache.init(cfg, B, S + 4, device="cpu"))
    b = pl.llama_forward(params, cfg, torch.as_tensor(ids), attention_mask=torch.as_tensor(mask), position_ids=pos,
                         cache=pl.KVCache.init(cfg, B, S + 4, device="cpu"))
    assert torch.equal(a["logits"], b["logits"])
    with pytest.raises(ValueError, match="matches neither"):
        pl.llama_forward(params, cfg, torch.as_tensor(ids), attention_mask=full[:, :3],
                         cache=pl.KVCache.init(cfg, B, S + 4, device="cpu"))
    with pytest.raises(ValueError, match="do not fit"):
        pl.llama_forward(params, cfg, torch.as_tensor(ids), cache=pl.KVCache.init(cfg, B, S - 1, device="cpu"))


def _jax_gaps(jparams, jcfg, out, mask, n_new, iv=None, prompt_only=False, embeds=None):
    """(B, n_new) top-2 gaps of the JAX side's logits at each generated step,
    from one cache-free forward over prompt + generated ids (positions as
    in generation; the intervention at every position, or at the prompt's
    only)."""
    B, total = out.shape
    S_p = total - n_new
    m = np.ones((B, S_p), np.int64) if mask is None else np.asarray(mask)
    full = np.concatenate([m, np.ones((B, n_new), np.int64)], axis=1)
    interventions = None
    if iv is not None:
        fn = (lambda h: jnp.concatenate([iv(h[:, :S_p]), h[:, S_p:]], axis=1)) if prompt_only else iv
        interventions = {"layers.1": fn}
    kw = {}
    if embeds is not None:
        new = jparams["embed_tokens"][jnp.asarray(out[:, S_p:])]
        kw["inputs_embeds"] = jnp.concatenate([embeds, new.astype(embeds.dtype)], axis=1)
    logits = jl.llama_forward(
        jparams, jcfg, None if embeds is not None else jnp.asarray(out), attention_mask=jnp.asarray(full),
        position_ids=jnp.asarray(_positions(full)), interventions=interventions, **kw,
    )["logits"]
    top2 = np.sort(np.asarray(logits[:, S_p - 1:total - 1], np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _compare_tokens(got, ref, gaps, n_new, min_steps=MIN_STEPS):
    """Token ids equal up to the first step at which some row's JAX-side
    top-2 gap is under NEAR_TIE; returns the number of steps compared."""
    ties = np.nonzero((gaps < NEAR_TIE).any(axis=0))[0]
    steps = int(ties[0]) if len(ties) else n_new  # from a tied step on, the argmax may differ
    assert steps >= min(min_steps, n_new), f"a near tie at step {steps}: too few steps compared"
    S_p = ref.shape[1] - n_new
    np.testing.assert_array_equal(got[:, :S_p + steps], ref[:, :S_p + steps])
    return steps


def _scale_iv(h):
    """An intervention both frameworks compute alike."""
    return h * 1.5 + 0.25


CASES = {
    "unpadded": dict(padded=False),
    "left-padded": dict(padded=True),
    "eos-int": dict(padded=True, eos="int"),
    "eos-list-all-done": dict(padded=True, eos="list"),
    "max-new-tokens-1": dict(padded=True, new=1),
    "intervene-prefill-only": dict(padded=True, iv=True, prefill_only=True),
    "intervene-every-step": dict(padded=True, iv=True, prefill_only=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generate_matches_jax(subject, case):
    """`greedy_generate` tokens against the JAX package's, NEW new tokens.
    EOS cases take their stop ids from the unstopped JAX run: one row's
    step-3 token as an int, and each row's step-2 token as a list (every
    row stops by step 2, so the loop ends early and the tail is filled)."""
    spec = CASES[case]
    jparams, params = subject
    jcfg, cfg = _cfgs(False)
    ids, mask = _prompt(spec["padded"])
    n_new = spec.get("new", NEW)
    kw = dict(max_new_tokens=n_new, attention_mask=mask)
    if "eos" in spec:
        free = np.asarray(jl.greedy_generate(jparams, jcfg, jnp.asarray(ids), **kw))[:, S:]
        kw["eos_token_id"] = int(free[0, 3]) if spec["eos"] == "int" else [int(t) for t in free[:, 2]]
    jkw, pkw = dict(kw), dict(kw)
    if spec.get("iv"):
        jkw.update(interventions={"layers.1": _scale_iv}, intervene_prefill_only=spec["prefill_only"])
        pkw.update(interventions={"layers.1": _scale_iv}, intervene_prefill_only=spec["prefill_only"])
    ref = np.asarray(jl.greedy_generate(jparams, jcfg, jnp.asarray(ids), **jkw))
    got = pl.greedy_generate(params, cfg, ids, **pkw).numpy()
    assert got.shape == ref.shape == (len(LEFT_PADS), S + n_new)
    gaps = _jax_gaps(jparams, jcfg, ref, mask, n_new, _scale_iv if spec.get("iv") else None,
                     prompt_only=spec.get("prefill_only", False))
    _compare_tokens(got, ref, gaps, n_new)
    if spec.get("eos") == "list":
        stop = kw["eos_token_id"][0]
        assert (got[:, S + 3:] == stop).all(), "every row stopped by step 2: the tail is the first stop id"
    if spec.get("eos") == "int":
        assert (got[0, S + 4:] == kw["eos_token_id"]).all(), "a stopped row is filled with the stop id"


def test_model_generate_reads_eos_from_generation_config(subject):
    jparams, params = subject
    _, cfg = _cfgs(False)
    ids, _ = _prompt(False)
    model = pl.LlamaModel(params, cfg)
    free = model.generate({"input_ids": ids}, max_new_tokens=6).numpy()
    model.generation_config = {"eos_token_id": [int(free[1, S + 1])]}
    stopped = model.generate({"input_ids": ids}, max_new_tokens=6).numpy()
    assert (stopped[1, S + 1:] == free[1, S + 1]).all()
    assert np.array_equal(stopped[:, :S + 2], free[:, :S + 2])


def test_right_padding_raises(subject):
    jparams, params = subject
    jcfg, cfg = _cfgs(False)
    ids, _ = _prompt(False)
    mask = np.ones_like(ids)
    mask[1, -3:] = 0
    with pytest.raises(ValueError, match="LEFT-padded"):
        jl.greedy_generate(jparams, jcfg, jnp.asarray(ids), 4, attention_mask=mask)
    with pytest.raises(ValueError, match="LEFT-padded"):
        pl.greedy_generate(params, cfg, ids, 4, attention_mask=mask)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("top_p", [0.3, 0.9, 0.99])
def test_top_p_filter_matches_jax_and_hf(tied, top_p):
    """The mask of `top_p_filter` exactly as the JAX package's, on random
    logits and on logits with tie classes across the nucleus boundary (the
    stable sort keeps the higher-index members of a boundary tie class), and
    as transformers' `TopPLogitsWarper`'s on the random ones.  Transformers
    sorts without `stable=True`, so which members of a tie class it keeps
    depends on the sort's implementation."""
    from transformers.generation.logits_process import TopPLogitsWarper

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 64)).astype(np.float32)
    if tied:
        logits = np.round(logits * 2) / 2  # tie classes of equal logits
        logits[0] = 0.0  # a flat row: one tie class
    got = pl.top_p_filter(torch.from_numpy(logits), top_p).numpy()
    ref = np.asarray(jl.top_p_filter(jnp.asarray(logits), jnp.float32(top_p)))
    hf = TopPLogitsWarper(top_p=top_p)(None, torch.from_numpy(logits.copy())).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    if not tied:
        np.testing.assert_array_equal(np.isinf(got), np.isinf(hf))
    np.testing.assert_array_equal(got[~np.isinf(got)], logits[~np.isinf(got)])
    assert (~np.isinf(got)).any(axis=1).all(), "at least one token survives"


def test_sampled_distribution_matches_warped_softmax(subject):
    """65,536 first-token draws (one prompt repeated on the batch axis)
    against the temperature- and top-p-warped softmax of the JAX side's
    logits, computed with transformers' warpers.  Every draw lies in the
    nucleus, and the total variation between the draws' histogram and that
    distribution is under twice its expected value for an exact sampler,
    0.5 * sum_i sqrt(2 p_i (1 - p_i) / (pi n)).  The bound can tell the
    warpers apart: the distribution without the temperature, and the one
    without top-p, each lie more than twice the bound away."""
    from transformers.generation.logits_process import TemperatureLogitsWarper, TopPLogitsWarper

    jparams, params = subject
    jcfg, cfg = _cfgs(False)
    temperature, top_p, B = 0.8, 0.9, 65536
    prompt = np.array([[1, 5, 9, 42]])
    out = pl.greedy_generate(params, cfg, np.repeat(prompt, B, axis=0), 1, do_sample=True,
                             temperature=temperature, top_p=top_p, seed=7).numpy()
    samples = out[:, -1]
    logits = torch.tensor(np.asarray(jl.llama_forward(jparams, jcfg, jnp.asarray(prompt))["logits"][:, -1]))

    def warped(t, p):
        return torch.softmax(TopPLogitsWarper(top_p=p)(None, TemperatureLogitsWarper(t)(None, logits)), -1).numpy()[0]

    probs = warped(temperature, top_p)
    bound = 2 * 0.5 * np.sqrt(2 * probs * (1 - probs) / (np.pi * B)).sum()
    for other in (warped(1.0, top_p), warped(temperature, 1.0)):
        assert 0.5 * np.abs(other - probs).sum() > 2 * bound
    assert probs[samples].min() > 0
    emp = np.bincount(samples, minlength=TINY["vocab_size"]) / B
    tv = 0.5 * np.abs(emp - probs).sum()
    assert tv < bound, f"total variation {tv:.4f}, bound {bound:.4f}"


def test_sampling_seed_temperature_and_greedy_limit(subject):
    """Temperature 1e-4 gives the greedy tokens; one seed gives the same
    tokens twice and another seed others; temperature <= 0 raises, as in
    the JAX package."""
    jparams, params = subject
    jcfg, cfg = _cfgs(False)
    ids = np.array([[1, 5, 9, 42, 100]])
    greedy = pl.greedy_generate(params, cfg, ids, 6).numpy()
    cold = pl.greedy_generate(params, cfg, ids, 6, do_sample=True, temperature=1e-4, seed=3).numpy()
    np.testing.assert_array_equal(greedy, cold)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5, top_p=0.95)
    a = pl.greedy_generate(params, cfg, np.repeat(ids, 4, axis=0), seed=11, **kw).numpy()
    b = pl.greedy_generate(params, cfg, np.repeat(ids, 4, axis=0), seed=11, **kw).numpy()
    c = pl.greedy_generate(params, cfg, np.repeat(ids, 4, axis=0), seed=12, **kw).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    for t in (0.0, -1.0):
        with pytest.raises(ValueError, match="temperature > 0"):
            jl.greedy_generate(jparams, jcfg, jnp.asarray(ids), 2, do_sample=True, temperature=t)
        with pytest.raises(ValueError, match="temperature > 0"):
            pl.greedy_generate(params, cfg, ids, 2, do_sample=True, temperature=t)


@pytest.fixture(scope="module")
def llava():
    from torch_llava_tiny import models

    return models(seed=0)


@pytest.mark.parametrize("two_images", [False, True], ids=["one-image", "two-sizes-right-padded"])
def test_llava_generate_matches_jax(llava, two_images):
    """`LlavaNextModel.generate` tokens against the JAX package's on the
    tiny LLaVA: one image, and a right-padded batch of two images of
    different sizes, which both repack to left padding."""
    from torch_llava_tiny import BOS, IMG_TOKEN, images

    from multimodal_sae_tpu.models.llava_next import _repack_left_padded
    from multimodal_sae_tpu_torch.models.llava_next import repack_left_padded

    jmodel, model = llava
    sizes = [(40, 60), (70, 30)] if two_images else [(40, 60)]
    ims = images(sizes)
    prompts = [[BOS, 7, IMG_TOKEN, 9, 11][: 5 - i] for i in range(len(sizes))]
    jbatch = jmodel.prepare_inputs(images=ims, prompt_ids=prompts)
    batch = model.prepare_inputs(images=ims, prompt_ids=prompts)
    if two_images:
        assert not np.asarray(batch["attention_mask"]).all(), "the rows must be right-padded"
    ref = np.asarray(jmodel.generate(jbatch, max_new_tokens=NEW))
    got = model.generate(batch, max_new_tokens=NEW).numpy()
    repacked = repack_left_padded(batch)
    np.testing.assert_array_equal(repacked["input_ids"], _repack_left_padded(jbatch)["input_ids"])
    assert got.shape == ref.shape
    jrep = _repack_left_padded(jbatch)
    embeds = jmodel._embed_multimodal(jrep)
    gaps = _jax_gaps(jmodel.params["language_model"], jmodel.cfg.text_config, ref, jrep.get("attention_mask"), NEW,
                     embeds=embeds)
    _compare_tokens(got, ref, gaps, NEW)
