"""The PyTorch port's cache path against the JAX package.

(a) The writer, byte for byte: the same (vals, idx) batches, taken from the
    JAX package's `topk_latents_step`, through both packages' `FeatureCache`
    host paths (streaming and buffered) give byte-equal merged
    `{start}_{end}.safetensors` splits and `.featidx` sidecars.
(b) The slice end to end: a tiny LLaMA (weights from the JAX package's
    `init_llama_params`, carried by `convert.py`) feeding a d_in 64,
    32,768-latent, k=128 SAE through `FeatureCache.run` in both packages.
(c) The CLIs: the port's on `synthetic://` with a tokenized dataset on disk,
    against the port's library path; both packages' on one tiny checkpoint.

Tolerances of (b) and (c): fp32 on both sides, matmuls summed in different
orders, so activations agree within rtol 1e-5, and per token the index sets
are equal except at tokens whose JAX-side k-th and (k+1)-th latents lie
within 1e-5 relative, which must be under 1% of the tokens.
"""

import dataclasses
import functools
import hashlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import CacheConfig as JaxCacheConfig
from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.cache import Cache as JaxCache
from multimodal_sae_tpu.features.cache import FeatureCache as JaxFeatureCache
from multimodal_sae_tpu.features.cache import topk_latents_step as jax_topk_latents_step
from multimodal_sae_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlamaModel
from multimodal_sae_tpu.models.llama import init_llama_params as jax_init_llama_params
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu.sae.model import pre_acts as jax_pre_acts
from multimodal_sae_tpu_torch.config import CacheConfig, SaeConfig
from multimodal_sae_tpu_torch.convert import llama_params_from_jax, sae_params_from_jax
from multimodal_sae_tpu_torch.features.cache import Cache, FeatureCache
from multimodal_sae_tpu_torch.features.split_index import index_path, mmap_safetensors, read_index, write_index
from multimodal_sae_tpu_torch.models import SyntheticActivationSource
from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
from multimodal_sae_tpu_torch.sae import Sae
from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

RTOL = 1e-5
K = 128
WIDTH = 32768
HOOK = "layers.1"
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)


def _digests(d):
    return {
        f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
        for f in sorted(os.listdir(d))
    }


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


# ---- (a) the writer, byte for byte -------------------------------------------------


def _jax_topk_batches(n_batches=3, B=2, S=5, k=8, width=64, d_in=16):
    """Index-ascending (vals, idx) batches from the JAX cache step, on an SAE
    whose negative encoder bias leaves some of each token's k at zero (so
    the 1e-5 threshold drops them)."""
    jsae = JaxSae(d_in, JaxSaeConfig(num_latents=width, k=k), key=jax.random.PRNGKey(2))
    jsae.params["b_enc"] = jnp.full((width,), -0.9, jnp.float32)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n_batches):
        x = jnp.asarray(rng.normal(size=(B, S, d_in)).astype(np.float32))
        vals, idx = jax_topk_latents_step(jsae.params, x, jsae.cfg)
        out.append((np.asarray(vals), np.asarray(idx)))
    n_zero = sum(int((v <= 1e-5).sum()) for v, _ in out)
    assert 0 < n_zero < sum(v.size for v, _ in out)
    return out


def _fc_shell(cls, cache_cls, width=64, batch_size=2):
    """A FeatureCache with no subject: the writer half alone."""
    fc = cls.__new__(cls)
    fc.cache = cache_cls(shard_size=10, batch_size=batch_size)
    fc.width = width
    fc.batch_size = batch_size
    fc.activation_dtype = np.dtype(np.float32)
    fc._stream = None
    fc._stream_marks = {}
    fc._row_cursor = 0
    return fc


@pytest.mark.parametrize("streaming", [True, False], ids=["streaming", "buffered"])
def test_writer_outputs_byte_equal(tmp_path, streaming):
    batches = _jax_topk_batches()
    n_splits = 4
    for name, cls, cache_cls, wrap in (
        ("jax", JaxFeatureCache, JaxCache, lambda v, i: (v, i)),
        ("port", FeatureCache, Cache, lambda v, i: (torch.from_numpy(v.copy()), torch.from_numpy(i.copy()), None)),
    ):
        fc = _fc_shell(cls, cache_cls)
        out = str(tmp_path / name)
        if streaming:
            fc.enable_streaming(out, n_splits)
        for b, (vals, idx) in enumerate(batches):
            fc._host_step({"m": wrap(vals, idx)}, b, len(vals))
        fc.cache.save()
        fc.save_splits(n_splits, out)
        fc.concate_safetensors(n_splits, out)
    jax_files, port_files = _digests(tmp_path / "jax" / "m"), _digests(tmp_path / "port" / "m")
    assert len(port_files) == 2 * n_splits  # splits + .featidx sidecars
    assert port_files == jax_files
    split = str(tmp_path / "port" / "m" / "0_15.safetensors")
    n = mmap_safetensors(split)["locations"].shape[0]
    order, feats = read_index(split, n)
    assert n > 0 and (np.diff(feats) >= 0).all()


def test_writer_outputs_byte_equal_with_sidecars_disabled(tmp_path, monkeypatch):
    """With MMSAE_NO_FEATIDX set, both packages write the same split bytes
    and no `.featidx`, and the port reads no sidecar."""
    monkeypatch.setenv("MMSAE_NO_FEATIDX", "1")
    batches = _jax_topk_batches()
    n_splits = 4
    for name, cls, cache_cls, wrap in (
        ("jax", JaxFeatureCache, JaxCache, lambda v, i: (v, i)),
        ("port", FeatureCache, Cache, lambda v, i: (torch.from_numpy(v.copy()), torch.from_numpy(i.copy()), None)),
    ):
        fc = _fc_shell(cls, cache_cls)
        for b, (vals, idx) in enumerate(batches):
            fc._host_step({"m": wrap(vals, idx)}, b, len(vals))
        fc.cache.save()
        fc.save_splits(n_splits, str(tmp_path / name))
        fc.concate_safetensors(n_splits, str(tmp_path / name))
    port_files = _digests(tmp_path / "port" / "m")
    assert len(port_files) == n_splits and all(f.endswith(".safetensors") for f in port_files)
    assert port_files == _digests(tmp_path / "jax" / "m")
    split = str(tmp_path / "port" / "m" / "0_15.safetensors")
    n = mmap_safetensors(split)["locations"].shape[0]
    assert not write_index(split, mmap_safetensors(split)["locations"][:, 2])
    assert not os.path.exists(index_path(split))
    monkeypatch.delenv("MMSAE_NO_FEATIDX")
    assert write_index(split, mmap_safetensors(split)["locations"][:, 2])
    assert read_index(split, n) is not None
    monkeypatch.setenv("MMSAE_NO_FEATIDX", "1")
    assert read_index(split, n) is None


@pytest.mark.parametrize("cap", ["0", "100", None], ids=["disabled", "small", "default"])
def test_prefault_cap_follows_the_environment(monkeypatch, cap):
    """`MMSAE_PREALLOC_MAX_ENTRIES` caps the entries `run` pre-faults per
    hookpoint, 0 turning it off, as the JAX package reads it."""
    if cap is None:
        monkeypatch.delenv("MMSAE_PREALLOC_MAX_ENTRIES", raising=False)
    else:
        monkeypatch.setenv("MMSAE_PREALLOC_MAX_ENTRIES", cap)
    fc = _fc_shell(FeatureCache, Cache)
    fc.submodule_dict = {"m": Sae(16, SaeConfig(num_latents=64, k=8), seed=0, device="cpu")}
    asked = []
    monkeypatch.setattr(fc.cache, "preallocate", lambda m, n, act_dtype: asked.append((m, n)))
    fc._preallocate_arenas(16, _rows(n=4, s=16))
    expected = {"0": [], "100": [("m", 100)], None: [("m", 16 * 4 * 8)]}[cap]
    assert asked == expected


def test_writer_matches_the_locked_golden_digests(tmp_path):
    """The port reproduces tests/test_golden_formats.py's locked split bytes."""
    cache = Cache(shard_size=0, batch_size=2)
    vals = np.zeros((2, 3, 2), dtype=np.float32)
    idx = np.zeros((2, 3, 2), dtype=np.int64)
    vals[0, 0] = [1.5, 0.25]
    idx[0, 0] = [1, 6]
    vals[1, 2] = [3.0, 2.0]
    idx[1, 2] = [0, 7]
    cache.add_topk(vals, idx, batch_number=0, module_path="m")
    cache.save()
    fc = FeatureCache.__new__(FeatureCache)
    fc.cache, fc.width, fc._stream = cache, 8, None
    fc.save_splits(2, str(tmp_path))
    fc.concate_safetensors(2, str(tmp_path))
    got = {f: h[:16] for f, h in _digests(tmp_path / "m").items() if f.endswith(".safetensors")}
    assert got == {"0_3.safetensors": "0f61c9b77b220bbc", "4_7.safetensors": "5847850f1d52b87d"}


def test_concate_merges_ranks_in_numeric_order(tmp_path):
    """Shards of ranks 10 and 2 merge rank 2 first (a string sort would put
    Rank10 first), byte-equal to the JAX package's merge."""
    batches = _jax_topk_batches(n_batches=2)
    for name, cls, cache_cls, wrap in (
        ("jax", JaxFeatureCache, JaxCache, lambda v, i: (v, i)),
        ("port", FeatureCache, Cache, lambda v, i: (torch.from_numpy(v.copy()), torch.from_numpy(i.copy()), None)),
    ):
        for rank, (vals, idx) in zip((10, 2), batches):
            fc = _fc_shell(cls, cache_cls)
            fc.cache.shard_size = rank * 100
            fc._host_step({"m": wrap(vals, idx)}, 0, len(vals))
            fc.cache.save()
            fc.save_splits(2, str(tmp_path / name), rank=rank)
        fc.concate_safetensors(2, str(tmp_path / name))
    assert _digests(tmp_path / "port" / "m") == _digests(tmp_path / "jax" / "m")
    locs, _ = _merged(tmp_path / "port" / "m")
    first = load_file(str(tmp_path / "port" / "m" / "0_31.safetensors"))["locations"].numpy()
    assert first[0, 0] < 1000 <= first[-1, 0] and len(locs) > 0


def test_synthetic_source_matches_jax_with_its_table():
    """The port's synthetic subject cannot draw jax.random's bits; handed
    the JAX source's embedding table, it captures the same hiddens."""
    from multimodal_sae_tpu.models import SyntheticActivationSource as JaxSyntheticActivationSource

    jsrc = JaxSyntheticActivationSource(d_model=16, n_layers=3, vocab=32, seed=1)
    src = SyntheticActivationSource(d_model=16, n_layers=3, vocab=32, embed=np.asarray(jsrc.embed), device="cpu")
    batch = {"input_ids": np.random.default_rng(0).integers(0, 32, size=(2, 7))}
    ref = jsrc.capture(batch, ["layers.0", "layers.2"])
    got = src.capture(batch, ["layers.0", "layers.2"])
    for hook in ref:
        np.testing.assert_allclose(got[hook].numpy(), np.asarray(ref[hook]), rtol=1e-6, atol=1e-7)


# ---- (b) the slice end to end ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_sae():
    return JaxSae(64, JaxSaeConfig(num_latents=WIDTH, k=K), key=jax.random.PRNGKey(1))


def _rows(n=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(1, 128, size=s)} for _ in range(n)]


def _merged(d):
    files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    assert files and not any(f.startswith("Rank") for f in files)
    data = [load_file(os.path.join(d, f)) for f in files]
    return (np.concatenate([x["locations"].numpy() for x in data]),
            np.concatenate([x["activations"].numpy() for x in data]))


def _by_token(locs, acts):
    out = {}
    for (row, pos, feat), a in zip(locs.tolist(), acts.tolist()):
        out.setdefault((row, pos), {})[feat] = a
    return out


def _assert_same_cache(port_dir, jax_dir, hiddens, jsae, row_offset):
    """Per token: equal index sets and activations within RTOL, except at
    near-tie tokens (JAX-side k-th and (k+1)-th latents within RTOL), which
    must be under 1% of the tokens."""
    pre = np.asarray(jax_pre_acts(jsae.params, jnp.asarray(hiddens.reshape(-1, hiddens.shape[-1]))))
    top = -np.sort(-pre, axis=-1)[:, : K + 1]
    near_tie = top[:, K - 1] - top[:, K] <= RTOL * np.abs(top[:, K - 1])
    S = hiddens.shape[1]
    port, ref = _by_token(*_merged(port_dir)), _by_token(*_merged(jax_dir))
    assert set(port) == set(ref) and len(ref) == hiddens.shape[0] * S
    swapped = 0
    for key, feats in ref.items():
        got = port[key]
        if set(got) != set(feats):
            assert near_tie[(key[0] - row_offset) * S + key[1]], f"token {key}: sets differ without a near tie"
            swapped += 1
            continue
        f = sorted(feats)
        np.testing.assert_allclose([got[i] for i in f], [feats[i] for i in f], rtol=RTOL, atol=0)
    assert swapped < 0.01 * len(ref)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
def test_feature_cache_run_matches_jax(jax_sae, tmp_path, flash):
    rows, hooks, n_splits = _rows(), [HOOK], 4
    jparams = jax_init_llama_params(jax.random.PRNGKey(0), JaxLlamaConfig(**TINY), dtype=jnp.float32)
    jmodel = JaxLlamaModel(jparams, JaxLlamaConfig(**TINY, flash_attention=flash))
    model = LlamaModel(llama_params_from_jax(jparams, device="cpu"), LlamaConfig(**TINY, flash_attention=flash))
    sae = Sae(64, SaeConfig(num_latents=WIDTH, k=K), params=sae_params_from_jax(_np_params(jax_sae.params), "cpu"))

    for name, cls, m, s in (("jax", JaxFeatureCache, jmodel, jax_sae), ("port", FeatureCache, model, sae)):
        fc = cls(lambda b, m=m: m.capture(b, hooks), {HOOK: s}, batch_size=4, shard_size=8)
        fc.enable_streaming(str(tmp_path / name), n_splits)
        fc.run(16, rows, progress=False)
        fc.save_splits(n_splits, str(tmp_path / name))
        fc.concate_safetensors(n_splits, str(tmp_path / name))

    ids = np.stack([r["input_ids"] for r in rows])
    hiddens = np.asarray(jmodel.capture({"input_ids": ids}, hooks)[HOOK])
    _assert_same_cache(tmp_path / "port" / HOOK, tmp_path / "jax" / HOOK, hiddens, jax_sae, row_offset=8)
    locs, _ = _merged(tmp_path / "port" / HOOK)
    # every (row, position) kept all k of its latents, rows offset by shard_size
    assert len(locs) == 8 * 16 * K and set(locs[:, 0]) == set(range(8, 16))


# ---- (c) the CLIs -------------------------------------------------------------------


def test_port_cli_on_synthetic_matches_the_library_path(tmp_path):
    from datasets import Dataset

    from multimodal_sae_tpu_torch.launch.cache import cache as port_cli

    ids = np.random.default_rng(6).integers(0, 32, size=(6, 12))
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(tmp_path / "ds"))
    sae = Sae(16, SaeConfig(num_latents=256, k=8), seed=4, device="cpu")
    sae.save_to_disk(tmp_path / "saes" / "layers.2")
    port_cli.main(
        CacheConfig(model="synthetic://16,3,32", dataset=str(tmp_path / "ds"),
                    sae_path=str(tmp_path / "saes"), batch_size=2, ctx_len=12, n_splits=4,
                    save_dir=str(tmp_path / "cli")),
        device="cpu",
    )
    src = SyntheticActivationSource.from_spec("synthetic://16,3,32", device="cpu")
    fc = FeatureCache(lambda b: src.capture(b, ["layers.2"]), {"layers.2": sae}, batch_size=2)
    fc.enable_streaming(str(tmp_path / "lib"), 4)
    fc.run(12, [{"input_ids": r} for r in ids], progress=False)
    fc.save_splits(4, str(tmp_path / "lib"))
    fc.concate_safetensors(4, str(tmp_path / "lib"))
    cli_files = _digests(tmp_path / "cli" / "layers.2")
    assert len(cli_files) == 8 and cli_files == _digests(tmp_path / "lib" / "layers.2")


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    """A tiny random LlamaForCausalLM checkpoint with fabricated tokenizer
    files, so both CLIs load it offline."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("torch_cache_ckpt")
    torch.manual_seed(1)
    transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**TINY, max_position_embeddings=64)
    ).save_pretrained(d, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({str(i): i for i in range(128)}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0").save_pretrained(d)
    return str(d)


def test_cache_clis_match_on_a_checkpoint(llama_dir, jax_sae, tmp_path, monkeypatch):
    """Both CLIs, same flags (--flash_attention, --truncate_layers).  The
    CLIs load the subject in bf16, whose per-op rounding differs between XLA
    and PyTorch; both are pinned to fp32 here so the tolerances above hold."""
    from datasets import Dataset

    from multimodal_sae_tpu.launch import utils as jax_launch_utils
    from multimodal_sae_tpu.launch.cache import cache as jax_cli
    from multimodal_sae_tpu.models.hf_loader import load_llama as jax_load_llama
    from multimodal_sae_tpu_torch.launch import utils as port_launch_utils
    from multimodal_sae_tpu_torch.launch.cache import cache as port_cli

    monkeypatch.setattr(jax_launch_utils, "load_subject_model",
                        functools.partial(jax_launch_utils.load_subject_model, dtype=jnp.float32))
    monkeypatch.setattr(port_launch_utils, "load_subject_model",
                        functools.partial(port_launch_utils.load_subject_model, dtype=torch.float32))
    ids = np.stack([r["input_ids"] for r in _rows(n=6, s=12, seed=5)])
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(tmp_path / "ds"))
    jax_sae.save_to_disk(tmp_path / "saes" / HOOK)
    flags = dict(model=llama_dir, dataset=str(tmp_path / "ds"), sae_path=str(tmp_path / "saes"),
                 batch_size=2, ctx_len=12, n_splits=4, flash_attention=True, truncate_layers=2)
    jax_cli.main(JaxCacheConfig(save_dir=str(tmp_path / "jax"), **flags))
    port_cli.main(CacheConfig(save_dir=str(tmp_path / "port"), **flags), device="cpu")

    jparams, jcfg = jax_load_llama(llama_dir, dtype=jnp.float32)
    jmodel = JaxLlamaModel(jparams, dataclasses.replace(jcfg, flash_attention=True))
    hiddens = np.asarray(jmodel.capture({"input_ids": ids}, [HOOK])[HOOK])
    _assert_same_cache(tmp_path / "port" / HOOK, tmp_path / "jax" / HOOK, hiddens, jax_sae, row_offset=0)
    assert sorted(os.listdir(tmp_path / "port" / HOOK)) == sorted(os.listdir(tmp_path / "jax" / HOOK))


def test_chunk_and_tokenize_matches_jax(llama_dir):
    """The CLI's tokenization of an untokenized dataset, in both packages."""
    from datasets import Dataset
    from transformers import AutoTokenizer

    from multimodal_sae_tpu.train.data import chunk_and_tokenize as jax_chunk_and_tokenize
    from multimodal_sae_tpu_torch.train.data import chunk_and_tokenize

    rng = np.random.default_rng(8)
    texts = [" ".join(str(t) for t in rng.integers(1, 128, size=rng.integers(5, 40))) for _ in range(20)]
    data = Dataset.from_dict({"text": texts})
    tok = AutoTokenizer.from_pretrained(llama_dir)
    ref = jax_chunk_and_tokenize(data, tok, max_seq_len=16, load_from_cache_file=False)
    got = chunk_and_tokenize(data, tok, max_seq_len=16, load_from_cache_file=False)
    assert len(got) == len(ref) > 5
    np.testing.assert_array_equal(np.stack(got["input_ids"]), np.stack(ref["input_ids"]))


@pytest.mark.parametrize("flag", [{"int8_matmul": True}, {"load_in_8bit": True}, {"sae_int8": True}],
                         ids=lambda f: next(iter(f)))
def test_cli_passes_the_int8_flags_on(tmp_path, flag, monkeypatch):
    """The subject's flags reach `load_subject_model` (a synthetic subject
    has no weights to quantise, as in the JAX CLI); `--sae_int8` quantises
    the loaded SAEs' encoders."""
    from multimodal_sae_tpu_torch.launch import utils as launch_utils
    from multimodal_sae_tpu_torch.launch.cache import cache as port_cli
    from multimodal_sae_tpu_torch.models.quant import is_quantized

    if "sae_int8" in flag:
        Sae(16, SaeConfig(expansion_factor=2, k=2), device="cpu").save_to_disk(tmp_path / "saes" / "layers.0")
        monkeypatch.setattr(port_cli, "load_any_dataset", lambda *a: SimpleNamespace(column_names=["input_ids"]))
        _, _, saes, _ = port_cli.load(CacheConfig(model="synthetic://16,2,8", sae_path=str(tmp_path / "saes"),
                                                  **flag), device="cpu")
        assert is_quantized(saes["layers.0"].params["W_enc"])
        return
    loaded = []
    monkeypatch.setattr(launch_utils, "load_subject_model", lambda *a, **kw: loaded.append(kw) or (None, None, None))
    launch_utils.load_subject_or_synthetic(CacheConfig(model=str(tmp_path / "ckpt"), **flag), device="cpu")
    ((kw,),) = [loaded]
    assert {k: kw[k] for k in flag} == flag


@pytest.mark.parametrize("flag", [{"tp": 2}, {"dp": 2}])
def test_cli_refuses_options_of_later_slices(flag):
    """--tp and --dp are ported for checkpoint subjects (tests/test_torch_tp.py,
    tests/test_torch_dp.py); a synthetic subject has no weights to shard or
    copy and is refused."""
    from multimodal_sae_tpu_torch.launch.utils import load_subject_or_synthetic

    with pytest.raises(ValueError, match="synthetic"):
        load_subject_or_synthetic(CacheConfig(model="synthetic://4,1,8", **flag), device="cpu")
    model, _, _ = load_subject_or_synthetic(CacheConfig(model="synthetic://4,2,8", dp=1), device="cpu")
    assert model.hookpoint_names() == ["layers.0", "layers.1"]
