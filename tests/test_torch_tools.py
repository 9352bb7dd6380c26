"""The port's card tools (`multimodal_sae_tpu_torch/tools/`: model_steering,
probe_activations, text_activation_vis) and create_filters_from_attribution
against the JAX package's `tools/*.py`, on the CPU.

The subject is test_tools_cli.py's tiny HF LLaMA checkpoint (2 layers,
hidden 32, vocab 256, `LlamaForCausalLM` drawn by torch's seed 0, a
GPT2-style tokenizer made offline, here with a chat template and
`<image>` and `<|eot_id|>` as added tokens); the image probe's is a
LLaVA-NeXT checkpoint at CLIP-L/336's geometry (336 pixels, patch 14:
576 base tokens) and tiny widths, drawn with numpy as in
tests/torch_llava_tiny.py.  The SAEs (32,768 latents, k = 128: the
block-max route of `top_k`, K1's plain version here) are saved by the JAX
`Sae.save_to_disk` and loaded by both packages.  Each JAX tool runs
in-process (`main()` on a patched `sys.argv`), the port's through
`main(argv, device="cpu")`.

Tolerances.  fp32 (each CLI's `load_subject_model` patched to fp32):
greedy tokens equal up to the first step whose JAX-side top-2 logit gap
(a cache-free JAX forward over the generated ids) is under NEAR_TIE = 1e-4,
at least 8 steps; probe rankings equal wherever the JAX means of the
features at a rank differ by more than MEAN_NEAR_TIE (1e-5 of the largest
mean; the two sides sum the tokens in other orders, about 1e-7 apart);
activations within 1e-5 relative.  The steering CLIs in their defaults
(bf16; the port's prefill on K3's plain version, the JAX prefill eager):
the two sides' logits lie up to 2.5e-3 apart on this checkpoint, whose
logits are about 0.1 in size, so a step counts as a near tie under
BF16_NEAR_TIE = 2^-7; every port token must be the JAX cache-free argmax
over the port's own sequence wherever that gap is larger, and the tokens
equal to the JAX CLI's up to the first near tie.  Files without floats
compare byte for byte."""

import contextlib
import html.parser
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig  # noqa: E402
from multimodal_sae_tpu.features.steering import clamp_features_max as jax_clamp  # noqa: E402
from multimodal_sae_tpu.models import llama as jl  # noqa: E402
from multimodal_sae_tpu.sae import Sae as JaxSae  # noqa: E402
from multimodal_sae_tpu_torch.ops import block_max, flash_attention, gather_rows  # noqa: E402
from multimodal_sae_tpu_torch.tools import (  # noqa: E402
    create_filters_from_attribution as port_filters,
    model_steering as port_steering,
    probe_activations as port_probe,
    text_activation_vis as port_vis,
)

import torch_llava_tiny as tl  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NEAR_TIE = 1e-4
MIN_STEPS = 8
BF16_NEAR_TIE = 2.0**-7
MEAN_NEAR_TIE = 1e-5
ACT_RTOL = 1e-5
WIDTH, K = 32768, 128
FEATURE, CLAMP = 3, 80.0
NEW = 32


def _write_llama(d: Path) -> Path:
    cfg = transformers.LlamaConfig(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    vocab = {chr(33 + i): i for i in range(200)}
    vocab["<|endoftext|>"] = 200
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "GPT2Tokenizer", "model_max_length": 128,
        "chat_template": "{% for m in messages %}{{ m['content'][0]['text'] }}{% endfor %}"}))
    (d / "added_tokens.json").write_text(json.dumps({"<image>": 201, "<|eot_id|>": 202}))
    return d


PINPOINTS_336 = [[336, 336], [336, 672]]


def _write_llava(d: Path) -> Path:
    """LLaVA-NeXT with CLIP-L/336's geometry and tiny widths, the word-level
    tokenizer, chat template and processor of `torch_llava_tiny`."""
    from safetensors.torch import save_file
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers, processors

    hf_cfg = transformers.LlavaNextConfig(
        vision_config=transformers.CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                                    num_attention_heads=4, image_size=336, patch_size=14,
                                                    hidden_act="quick_gelu"),
        text_config=transformers.LlamaConfig(**{**tl.TEXT, "hidden_size": 32, "intermediate_size": 64,
                                                "num_hidden_layers": 2, "max_position_embeddings": 2048}),
        image_grid_pinpoints=PINPOINTS_336, image_token_index=tl.IMG_TOKEN, vision_feature_layer=-2,
        vision_feature_select_strategy="default")
    (d / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    save_file(tl.numpy_state_dict(hf_cfg, seed=5), str(d / "model.safetensors"))
    tok = Tokenizer(tok_models.WordLevel({str(i): i for i in range(256)}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["<image>", "<s>", "</s>"])
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", tl.BOS)])
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0", bos_token="<s>",
                                                eos_token="</s>")
    fast.chat_template = tl.CHAT_TEMPLATE
    fast.save_pretrained(d)
    transformers.LlavaNextProcessor(
        image_processor=transformers.LlavaNextImageProcessor(
            size={"shortest_edge": 336}, crop_size={"height": 336, "width": 336}, image_grid_pinpoints=PINPOINTS_336),
        tokenizer=fast, patch_size=14, vision_feature_select_strategy="default", image_token="<image>",
        num_additional_image_tokens=1,
    ).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The checkpoints, the JAX-saved SAEs (layers.0 and layers.1 of the
    LLaMA, model.layers.1 of the LLaVA) and a probe image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("tools")
    (root / "tiny_llama").mkdir()
    (root / "tiny_llama_llava").mkdir()
    _write_llama(root / "tiny_llama")
    _write_llava(root / "tiny_llama_llava")
    for seed, name in enumerate(("layers.0", "layers.1", "model.layers.1")):
        JaxSae(32, JaxSaeConfig(num_latents=WIDTH, k=K), key=jax.random.PRNGKey(seed)).save_to_disk(
            root / "saes" / name)
    pixels = np.random.default_rng(0).integers(0, 256, size=(300, 400, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(root / "image.png")
    return root


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fp32(monkeypatch, module, dtype):
    """`module.load_subject_model` pinned to `dtype`."""
    real = module.load_subject_model
    monkeypatch.setattr(module, "load_subject_model", lambda *a, **kw: real(*a, **{**kw, "dtype": dtype}))


def _run_jax(module, argv, monkeypatch) -> str:
    """The JAX tool's `main()` on `argv`; its standard output."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def _run_port(module, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(argv, device="cpu")
    return out.getvalue()


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions of K1, K2's decode and K3's forward,
    which the wrappers run on CPU tensors."""
    calls = {"block_max": 0, "gather_decode": 0, "flash_attention": 0}
    for module, name, key in ((block_max, "block_max_plain", "block_max"),
                              (gather_rows, "gather_decode_plain", "gather_decode"),
                              (flash_attention, "flash_attention_fwd_plain", "flash_attention")):
        real = getattr(module, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


def _subjects(root, dtype=jnp.float32):
    """(JAX, port) subject and tokenizer of the LLaMA checkpoint, each as its
    package's tool loads it, in `dtype`."""
    from multimodal_sae_tpu.launch.utils import load_subject_model as jax_load

    from multimodal_sae_tpu_torch.launch.utils import load_subject_model as port_load

    jmodel, _, tok = jax_load(str(root / "tiny_llama"), dtype=dtype)
    model, _, _ = port_load(str(root / "tiny_llama"), dtype=getattr(torch, jnp.dtype(dtype).name),
                            flash_attention=True, device="cpu")
    return jmodel, model, tok


def _saes(root, name="layers.1"):
    from multimodal_sae_tpu.interp_utils import load_single_sae as jax_load

    from multimodal_sae_tpu_torch.interp_utils import load_single_sae as port_load

    return jax_load(str(root / "saes"), name), port_load(str(root / "saes"), name, device="cpu")


# ---- model_steering ------------------------------------------------------------------


def _jax_top2(jmodel, seq: np.ndarray, n_new: int, jsae=None):
    """(argmax, gap) of the JAX side's logits at each of the n_new generated
    steps of `seq` (1, S_p + n_new), from one cache-free forward; with
    `jsae`, the clamp at the prompt's positions only, as the generate
    applies it at the prefill."""
    S_p = seq.shape[1] - n_new
    interventions = None
    if jsae is not None:
        clamp = jax_clamp(jsae, FEATURE, k=CLAMP)
        interventions = {"layers.1": lambda h: jnp.concatenate([clamp(h[:, :S_p]), h[:, S_p:]], axis=1)}
    logits = jl.llama_forward(jmodel.params, jmodel.cfg, jnp.asarray(seq), interventions=interventions)["logits"]
    step = np.asarray(logits[0, S_p - 1:-1], np.float32)
    top2 = np.sort(step, axis=-1)[:, -2:]
    return step.argmax(-1), top2[:, 1] - top2[:, 0]


def _equal_up_to_near_tie(got: np.ndarray, ref: np.ndarray, gaps: np.ndarray, margin: float, min_steps: int) -> int:
    """`got` equals `ref` (new ids, (n_new,)) up to the first step whose gap
    is under `margin`, which must come at `min_steps` or later."""
    ties = np.nonzero(gaps < margin)[0]
    steps = int(ties[0]) if len(ties) else len(gaps)
    assert steps >= min(min_steps, len(gaps)), f"a near tie at step {steps}: too few steps compared"
    np.testing.assert_array_equal(got[:steps], ref[:steps])
    return steps


def test_model_steering_core_matches_jax_fp32(root, plain_calls):
    """`steer` on the fp32 subject (the prefill on K3's plain version, the
    clamp on K1's and K2's) against the JAX tool's two generates, NEW
    tokens each."""
    from multimodal_sae_tpu.launch.utils import prepare_prompt_batch as jax_prepare

    from multimodal_sae_tpu_torch.launch.utils import prepare_prompt_batch

    jmodel, model, tok = _subjects(root)
    jsae, sae = _saes(root)
    _, _, batch = prepare_prompt_batch(model, None, tok, "hello there", use_chat_template=True)
    _, _, jbatch = jax_prepare(jmodel, None, tok, "hello there", use_chat_template=True)
    original, steered = port_steering.steer(model, sae, batch, "layers.1", FEATURE, CLAMP, max_new_tokens=NEW)
    assert all(plain_calls[name] >= 1 for name in plain_calls), plain_calls
    S_p = len(batch["input_ids"][0])
    refs = (np.asarray(jmodel.generate(jbatch, max_new_tokens=NEW)),
            np.asarray(jmodel.generate(jbatch, max_new_tokens=NEW, interventions={
                "layers.1": jax_clamp(jsae, FEATURE, k=CLAMP)}, intervene_prefill_only=True)))
    for got, ref, clamp in ((original, refs[0], None), (steered, refs[1], jsae)):
        assert got.shape == (1, NEW)
        _, gaps = _jax_top2(jmodel, ref, NEW, clamp)
        _equal_up_to_near_tie(got.numpy()[0], ref[0, S_p:], gaps, NEAR_TIE, MIN_STEPS)
    assert not np.array_equal(refs[0], refs[1]), "the clamp changes the answer"


def _recording(module, into: list):
    """`module.load_subject_model` whose model records each generate's
    output on the host."""
    real = module.load_subject_model

    def load(*a, **kw):
        model, processor, tok = real(*a, **kw)
        generate = model.generate

        def recorded(*ga, **gkw):
            out = generate(*ga, **gkw)
            into.append(np.asarray(out))
            return out

        model.generate = recorded
        return model, processor, tok

    return load


def test_model_steering_cli_matches_jax_in_its_defaults(root, monkeypatch):
    """Both CLIs end to end as a user runs them (bf16; 512 tokens), on the
    JAX CLI test's command: the printed sections, and each section's tokens
    held as the module docstring says."""
    jax_tool = _jax_tool("model_steering")
    jax_out, port_out = [], []
    monkeypatch.setattr(jax_tool, "load_subject_model", _recording(jax_tool, jax_out))
    monkeypatch.setattr(port_steering, "load_subject_model", _recording(port_steering, port_out))
    argv = ["--model", str(root / "tiny_llama"), "--sae-path", str(root / "saes"), "--module-name", "layers.1",
            "--feature_idx", str(FEATURE), "--clamp-value", str(CLAMP), "--text", "hello", "--pure-text"]
    jax_text = _run_jax(jax_tool, argv, monkeypatch)
    port_text = _run_port(port_steering, argv)

    jmodel, _, tok = _subjects(root, jnp.bfloat16)
    jsae, _ = _saes(root)
    n_new = port_steering.MAX_NEW_TOKENS
    lines = {"jax": jax_text.split("\n"), "port": port_text.split("\n")}
    for side, outs in (("jax", jax_out), ("port", port_out)):
        assert [o.shape[1] for o in outs] == [outs[0].shape[1]] * 2
        assert lines[side] == [port_steering.HEADINGS[0], tok.decode(outs[0][0, -n_new:], skip_special_tokens=True),
                               port_steering.HEADINGS[1], tok.decode(outs[1][0, -n_new:], skip_special_tokens=True),
                               ""]
    compared = []
    for got, ref, clamp in ((port_out[0], jax_out[0], None), (port_out[1], jax_out[1], jsae)):
        _, gaps = _jax_top2(jmodel, ref, n_new, clamp)
        compared.append(_equal_up_to_near_tie(got[0, -n_new:], ref[0, -n_new:], gaps, BF16_NEAR_TIE, 1))
        argmax, own_gaps = _jax_top2(jmodel, got, n_new, clamp)
        clear = own_gaps >= BF16_NEAR_TIE
        np.testing.assert_array_equal(got[0, -n_new:][clear], argmax[clear])
        assert clear.sum() > n_new // 2
    assert port_out[0].shape[1] - n_new == 5  # "hello": no template


def test_model_steering_reads_the_prompt_length_of_either_batch_form():
    assert port_steering.prompt_length({"input_ids": [[1, 2, 3]]}) == 3
    assert port_steering.prompt_length({"input_ids": np.zeros((1, 7), np.int64)}) == 7


# ---- probe_activations ---------------------------------------------------------------


def _jax_latents(jmodel, jsae, batch, hook: str, skip_bos: bool = False) -> np.ndarray:
    """The JAX tool's (tokens, latents) pre-activations of the batch's row."""
    latents = np.asarray(jsae.pre_acts(jmodel.capture(batch, [hook])[hook]))[0]
    return latents[1:] if skip_bos else latents


def _check_ranking(got, jax_mean: np.ndarray, interval):
    """`got` is `np.argsort(-jax_mean)[interval]` but for near ties: at
    each rank, the JAX means of the two features lie within MEAN_NEAR_TIE
    of the largest."""
    want = np.argsort(-jax_mean)[: interval[1]][interval[0]:]
    assert len(got) == len(want)
    margin = MEAN_NEAR_TIE * np.abs(jax_mean).max()
    np.testing.assert_allclose(jax_mean[np.asarray(got)], jax_mean[want], atol=margin, rtol=0)
    return int((np.asarray(got) == want).sum())


@pytest.mark.parametrize("interval", [None, "2-7"], ids=["top-k", "interval"])
def test_probe_activations_matches_jax_on_text(root, monkeypatch, plain_calls, interval):
    """The core on the fp32 subject against the JAX tool's mean and
    columns, then both CLIs' filters.json."""
    from multimodal_sae_tpu.launch.utils import prepare_prompt_batch as jax_prepare

    jmodel, model, tok = _subjects(root)
    jsae, sae = _saes(root)
    span = [2, 7] if interval else [0, 6]
    _, _, jbatch = jax_prepare(jmodel, None, tok, "hello world", use_chat_template=True)
    features, acts, mean = port_probe.probe(model, sae, {"input_ids": jbatch["input_ids"]}, "layers.1", span)
    assert plain_calls["flash_attention"] >= 1
    latents = _jax_latents(jmodel, jsae, jbatch, "layers.1")
    jax_mean = latents.mean(axis=0)
    np.testing.assert_allclose(mean, jax_mean, rtol=ACT_RTOL, atol=1e-6)
    _check_ranking(features, jax_mean, span)
    np.testing.assert_allclose(acts, latents[:, features].T, rtol=ACT_RTOL, atol=1e-6)

    jax_tool = _jax_tool("probe_activations")
    _fp32(monkeypatch, jax_tool, jnp.float32)
    _fp32(monkeypatch, port_probe, torch.float32)
    argv = ["--model", str(root / "tiny_llama"), "--sae-path", str(root / "saes"), "--module-name", "layers.1",
            "--text", "hello world", "--top-k", "6"] + (["--interval", interval] if interval else [])
    tmp = root / f"probe_{interval}"
    _run_jax(jax_tool, argv + ["--save-to", str(tmp / "jax")], monkeypatch)
    _run_port(port_probe, argv + ["--save-to", str(tmp / "port")])
    want = json.loads((tmp / "jax" / "filters.json").read_text())
    got = json.loads((tmp / "port" / "filters.json").read_text())
    assert list(got) == list(want) == ["layers.1"]
    _check_ranking(got["layers.1"], jax_mean, span)
    assert not (tmp / "port" / "images").exists()


def test_probe_activations_image_matches_jax(root, monkeypatch, plain_calls):
    """An image-only probe on the LLaVA checkpoint (its leading BOS
    skipped: the checkpoint's path names llama), both CLIs in fp32:
    filters.json, and each feature's PNG byte for byte where its two
    masks (the first 576 positions under 1e-5) are equal."""
    from multimodal_sae_tpu.launch.utils import load_subject_model as jax_load, prepare_prompt_batch as jax_prepare
    from PIL import Image

    hook, ckpt, out = "model.layers.1", root / "tiny_llama_llava", root / "probe_image"
    jax_tool = _jax_tool("probe_activations")
    _fp32(monkeypatch, jax_tool, jnp.float32)
    _fp32(monkeypatch, port_probe, torch.float32)
    argv = ["--model", str(ckpt), "--sae-path", str(root / "saes"), "--module-name", hook,
            "--image-path", str(root / "image.png"), "--top-k", "6"]
    _run_jax(jax_tool, argv + ["--save-to", str(out / "jax")], monkeypatch)
    _run_port(port_probe, argv + ["--save-to", str(out / "port")])
    assert plain_calls["flash_attention"] >= 1

    jmodel, processor, tok = jax_load(str(ckpt), dtype=jnp.float32)
    jsae, sae = _saes(root, hook)
    _, _, jbatch = jax_prepare(jmodel, processor, tok, None, Image.open(root / "image.png"),
                               use_chat_template=False, raw_prompt="<image>")
    latents = _jax_latents(jmodel, jsae, jbatch, hook, skip_bos=True)
    del jmodel
    assert latents.shape[0] > port_probe.BASE_IMG_TOKENS
    want = json.loads((out / "jax" / "filters.json").read_text())[hook]
    got = json.loads((out / "port" / "filters.json").read_text())[hook]
    _check_ranking(got, latents.mean(axis=0), [0, 6])
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model as port_load, prepare_prompt_batch as port_prepare

    model, processor, tok = port_load(str(ckpt), dtype=torch.float32, flash_attention=True, device="cpu")
    _, _, batch = port_prepare(model, processor, tok, None, Image.open(root / "image.png"),
                               use_chat_template=False, raw_prompt="<image>")
    _, acts, _ = port_probe.probe(model, sae, batch, hook, [0, 6], skip_bos=True)
    compared = 0
    for f, a in zip(got, acts):
        if f in want and np.array_equal(a[:576] < 1e-5, latents[:576, f] < 1e-5):
            assert (out / "port" / "images" / f"feat_{f}.png").read_bytes() == \
                (out / "jax" / "images" / f"feat_{f}.png").read_bytes()
            compared += 1
    assert compared >= 4
    assert sorted(os.listdir(out / "port" / "images")) == sorted(f"feat_{f}.png" for f in got)


# ---- text_activation_vis -------------------------------------------------------------


class _Page(html.parser.HTMLParser):
    """The page as (tag, text) events, with every span's alpha apart."""

    def __init__(self):
        super().__init__()
        self.events, self.alphas = [], []

    def handle_starttag(self, tag, attrs):
        style = dict(attrs).get("style", "")
        if style.startswith("background-color: rgba(255, 0, 0, "):
            self.alphas.append(float(style[len("background-color: rgba(255, 0, 0, "):-2]))
            style = "rgba"
        self.events.append((tag, style))

    def handle_endtag(self, tag):
        self.events.append(("/" + tag, ""))

    def handle_data(self, data):
        self.events.append(("text", data))


def _page(text: str) -> _Page:
    page = _Page()
    page.feed(text)
    page.close()
    return page


def test_text_activation_vis_matches_jax(root, monkeypatch, plain_calls):
    """Two hookpoints, a filter with features with and without an
    explanation: the core's columns against the JAX tool's dense scatter,
    and both CLIs' pages equal in structure, every colour's alpha within
    ACT_RTOL (fp32)."""
    from multimodal_sae_tpu.launch.utils import load_subject_model as jax_load

    exp_dir, out = root / "vis" / "explanations", root / "vis"
    exp_dir.mkdir(parents=True)
    jmodel, _, tok = jax_load(str(root / "tiny_llama"), dtype=jnp.float32)
    text = "hello world, the tools"
    ids = tok(text)["input_ids"]
    jsaes = {h: _saes(root, h)[0] for h in ("layers.0", "layers.1")}
    hiddens = jmodel.capture({"input_ids": np.asarray([ids])}, list(jsaes))
    selected = {}
    for h, jsae in jsaes.items():
        vals, idx = jsae.encode(hiddens[h])
        selected[h] = (np.asarray(vals)[0], np.asarray(idx)[0])
    # Features selected at some token (so their columns are not all 0),
    # one never selected, and one with no explanation.
    filters = {}
    for h, (_, idx) in selected.items():
        absent = np.setdiff1d(np.arange(WIDTH), idx)
        filters[h] = [int(i) for i in np.unique(idx)[:3]] + [int(absent[-1]), int(absent[0])]
    (root / "vis" / "filters.json").write_text(json.dumps(filters))
    (exp_dir / "layers.json").write_text(json.dumps(
        [{f"{h}_feature{i}": f"explanation of {h} {i}", "prompt": "p"} for h in filters for i in filters[h][:4]]))

    _, model, _ = _subjects(root)
    saes = {h: _saes(root, h)[1] for h in jsaes}
    columns = port_vis.feature_activations(model, saes, ids, filters)
    assert plain_calls["flash_attention"] >= 1 and plain_calls["block_max"] >= 1
    for h, (vals, idx) in selected.items():
        dense = np.zeros((len(ids), WIDTH), np.float32)
        np.put_along_axis(dense, idx, vals, axis=-1)
        np.testing.assert_allclose(columns[h], dense[:, filters[h]], rtol=ACT_RTOL, atol=0)
        assert np.count_nonzero(columns[h]) > 0

    jax_tool = _jax_tool("text_activation_vis")
    _fp32(monkeypatch, jax_tool, jnp.float32)
    _fp32(monkeypatch, port_vis, torch.float32)
    argv = ["--model-path", str(root / "tiny_llama"), "--sae-path", str(root / "saes"),
            "--explanation-dir", str(exp_dir), "--filters", str(out / "filters.json"), "--text", text]
    _run_jax(jax_tool, argv + ["--save-path", str(out / "jax.html")], monkeypatch)
    _run_port(port_vis, argv + ["--save-path", str(out / "port.html")])
    want, got = _page((out / "jax.html").read_text()), _page((out / "port.html").read_text())
    assert got.events == want.events
    assert len(got.alphas) == 8 * len(ids)
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=ACT_RTOL, atol=ACT_RTOL)
    assert f"layers.1_feature{filters['layers.1'][-1]}<" not in (out / "port.html").read_text()


def test_feature_columns_equal_the_dense_scatter():
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(50, size=6, replace=False) for _ in range(9)])
    vals = rng.random((9, 6), dtype=np.float32)
    dense = np.zeros((9, 50), np.float32)
    np.put_along_axis(dense, idx, vals, axis=-1)
    feats = [int(idx[0, 0]), 49, int(idx[4, 2]), int(idx[0, 0])]
    got = port_vis.feature_columns(torch.from_numpy(vals), torch.from_numpy(idx).int(), feats).numpy()
    assert np.array_equal(got, dense[:, feats])


# ---- create_filters_from_attribution -------------------------------------------------


PROBES = {
    "plain": "x a <image> b c d",
    # an end-of-turn marker after the image: the last 4 text positions go
    "eot": "x a <image> b c <|eot_id|> d e f g",
}


@pytest.mark.parametrize("case,pool,image_only", [("plain", "avg", False), ("eot", "max", False),
                                                  ("plain", "max", True)])
def test_create_filters_from_attribution_matches_jax_byte_for_byte(root, monkeypatch, case, pool, image_only):
    """Given one attribution file of two hookpoints: the filters json, the
    HTML (written to the working directory) and the PNGs equal byte for
    byte."""
    from PIL import Image
    from safetensors.numpy import save_file

    prompt = PROBES[case]
    out = root / f"filters_{case}_{pool}_{image_only}"
    # The map's token axis: the prompt's ids without BOS, the image token
    # expanded to 576 positions.
    tokens = transformers.AutoTokenizer.from_pretrained(root / "tiny_llama")(prompt)["input_ids"][1:]
    assert (202 in tokens) == (case == "eot")
    rng = np.random.default_rng(0)
    maps = {h: rng.standard_normal((64, len(tokens) - 1 + 576)).astype(np.float32)
            for h in ("model.layers.1", "model.layers.0")}
    image = out / "probe.png"
    out.mkdir()
    Image.fromarray(rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)).save(image)
    (out / "probe.json").write_text(json.dumps([{"prompt": prompt, "answer": "e", "baseline": "f",
                                                  "image": str(image)}]))
    jax_tool = _jax_tool("create_filters_from_attribution")
    for side in ("jax", "port"):
        (out / side).mkdir()
        save_file(maps, str(out / side / "attribution.safetensors"))
        argv = ["--attribution-path", str(out / side / "attribution.safetensors"),
                "--filters-path", str(out / side / "filters"), "--probing-data", str(out / "probe.json"),
                "--tokenizer", str(root / "tiny_llama"), "-k", "5", "--pool", pool] + (
                    ["--image-only"] if image_only else [])
        monkeypatch.chdir(out / side)
        if side == "jax":
            _run_jax(jax_tool, argv, monkeypatch)
        else:
            port_filters.main(argv)
    files = sorted(str(p.relative_to(out / "jax")) for p in (out / "jax").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(out / "port")) for p in (out / "port").rglob("*") if p.is_file())
    assert len([f for f in files if f.endswith(".png")]) == 10
    for f in files:
        assert (out / "port" / f).read_bytes() == (out / "jax" / f).read_bytes(), f
    filters = json.loads((out / "port" / "filters" / "filters_top_5_probe.json").read_text())
    assert list(filters) == ["model.layers.0", "model.layers.1"]
    assert all(len(v) == (5 if image_only else 10) for v in filters.values())
