"""Steering in the PyTorch port against the JAX package, on the CPU: the
clamp interventions, `SteeringController.run` on a text and an image
subject, the launch helpers it uses, and the steering and filter_steering
CLIs.

The subjects are the tiny LLaMA of tests/torch_llama_tiny.py and the tiny
LLaVA-NeXT of tests/torch_llava_tiny.py (fp32); the SAEs are the JAX
package's, carried by `convert.sae_params_from_jax`: one of width 1,024
(k = 8, `torch.topk`'s route) and one of width 32,768 at d_in 64 (k = 128,
the block-max route of `top_k`, whose reduce is K1's plain version here).
Tolerance: clamp outputs within 1e-5 absolute plus 1e-5 relative (fp32 on
both sides; the encoder sums 64 products and the decode k rows of outputs
up to about 20, in their own orders, about 1e-6 relative apart); generated
text and written files exactly."""

import importlib
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features import steering as jsteer
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.features import steering as psteer
from multimodal_sae_tpu_torch.sae import Sae

transformers = pytest.importorskip("transformers")
from PIL import Image  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
D = 64
NEW = 8
WIDTHS = {"1024": (1024, 8), "32768": (32768, 128)}


def _saes(width, k, seed=0):
    jsae = JaxSae(D, JaxSaeConfig(num_latents=width, k=k), key=jax.random.PRNGKey(seed))
    params = sae_params_from_jax({name: np.asarray(a) for name, a in jsae.params.items()}, device="cpu")
    return jsae, Sae(D, SaeConfig(num_latents=width, k=k), params=params)


@pytest.fixture(scope="module")
def sae_pairs():
    return {name: _saes(*wk) for name, wk in WIDTHS.items()}


def _hidden(B=3, S=7, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_clamp_matches_jax(sae_pairs, width):
    """`clamp_features_max` and `clamp_features_max_batched` against the
    JAX package's `_clamp_iv` and `_clamp_batched_iv` (through their
    `Intervention`s), within TOL."""
    jsae, sae = sae_pairs[width]
    h = _hidden()
    got = psteer.clamp_features_max(sae, 17, k=50.0)(torch.from_numpy(h)).numpy()
    ref = np.asarray(jsteer.clamp_features_max(jsae, 17, k=50.0)(jnp.asarray(h)))
    np.testing.assert_allclose(got, ref, **TOL)
    feats = [5, 17, 900]
    got = psteer.clamp_features_max_batched(sae, feats, k=50.0)(torch.from_numpy(h)).numpy()
    ref = np.asarray(jsteer.clamp_features_max_batched(jsae, feats, k=50.0)(jnp.asarray(h)))
    np.testing.assert_allclose(got, ref, **TOL)
    assert not np.allclose(got[0], got[1], atol=1e-3), "rows steered by other features differ"


@pytest.mark.parametrize("width", list(WIDTHS))
def test_token_chunked_clamp_equals_unchunked(sae_pairs, width):
    """The clamp over chunks of 4 and of 5 tokens (chunks that end inside a
    row) against one chunk of all 21: tokens are independent, so the
    outputs agree within 1e-6 absolute plus 1e-6 relative (the encoder's
    matmul may block other row counts differently: a few fp32 ulps)."""
    _, sae = sae_pairs[width]
    h = torch.from_numpy(_hidden())
    feats = torch.tensor([5, 17, 900])
    whole = psteer.clamp_hidden(sae, h, feats, 50.0, chunk=10**6)
    for chunk in (4, 5):
        torch.testing.assert_close(psteer.clamp_hidden(sae, h, feats, 50.0, chunk=chunk), whole, atol=1e-6, rtol=1e-6)


class FakeTokenizer:
    """Chat template, tokenizer and decoder in one (a text subject's
    processor is its tokenizer); `<image>` becomes the image token."""

    def __init__(self, image_token=None, bos=1, eos_token_id=None):
        self.image_token, self.bos, self.eos_token_id = image_token, bos, eos_token_id

    def apply_chat_template(self, conversation, add_generation_prompt=False, tokenize=False):
        text = conversation[0]["content"][0]["text"]
        has_image = any(c.get("type") == "image" for c in conversation[0]["content"])
        return ("<image>" if has_image else "") + f"<user>{text}<assistant>"

    def __call__(self, text, **kw):
        ids = [self.bos]
        for i, part in enumerate(text.split("<image>")):
            if i:
                ids.append(self.image_token)
            ids += [2 + (ord(c) % 100) for c in part]
        return {"input_ids": ids}

    def batch_decode(self, arr, skip_special_tokens=True):
        return [" ".join(str(int(t)) for t in row) for row in np.asarray(arr)]


class FakeProcessor:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def apply_chat_template(self, *args, **kw):
        return self.tokenizer.apply_chat_template(*args, **kw)


@pytest.fixture(scope="module")
def text_subject():
    from torch_llama_tiny import models

    return models(seed=0)


@pytest.fixture(scope="module")
def image_subject():
    from torch_llava_tiny import models

    return models(seed=0)


@pytest.fixture
def image_path(tmp_path):
    path = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 60, 3), dtype=np.uint8)).save(path)
    return str(path)


def _run(controller_cls, sae, model, processor, feats, fbs, image=None, hook="layers.1", **kw):
    return controller_cls(sae=sae, module_name=hook, feature_idx=feats, model=model, processor=processor,
                          prompt="hi there", image_path=image, k=50.0, max_new_tokens=NEW,
                          feature_batch_size=fbs, **kw).run()


FEATURES = [3, 17, 250, 600, 901]


@pytest.mark.parametrize("fbs", [1, 3], ids=["feature-batch-1", "feature-batch-3-ragged"])
def test_controller_matches_jax_text(text_subject, sae_pairs, fbs):
    """The result dict of `SteeringController.run` on the text subject equals
    the JAX controller's (5 features: chunks of 1, or 3 and a ragged 2), and
    the steered answers differ from the baseline somewhere."""
    jmodel, model = text_subject
    jsae, sae = sae_pairs["1024"]
    tok = FakeTokenizer()
    ref = _run(jsteer.SteeringController, jsae, jmodel, tok, FEATURES, fbs)
    got = _run(psteer.SteeringController, sae, model, tok, FEATURES, fbs)
    assert got == ref
    assert list(got) == [f"layers.1_feature{f}" for f in FEATURES]
    assert any(r["clamped_resps"] != r["original_resps"] for r in got.values())


@pytest.mark.parametrize("fbs", [1, 3], ids=["feature-batch-1", "feature-batch-3-ragged"])
def test_controller_matches_jax_image(image_subject, sae_pairs, image_path, fbs, monkeypatch):
    """The same on the tiny LLaVA with an image, hookpoint
    "model.layers.1"; rows of a chunk share one pixel array, so the tower
    runs once per generate call."""
    from torch_llava_tiny import IMG_TOKEN

    from multimodal_sae_tpu_torch.models import llava_next

    jmodel, model = image_subject
    jsae, sae = sae_pairs["1024"]
    proc = FakeProcessor(FakeTokenizer(image_token=IMG_TOKEN))
    ref = _run(jsteer.SteeringController, jsae, jmodel, proc, FEATURES, fbs, image=image_path, hook="model.layers.1")
    calls = []
    real = llava_next.project_image_features

    def counted(params, cfg, pixel_values):
        calls.append(pixel_values.shape[0])
        return real(params, cfg, pixel_values)

    monkeypatch.setattr(llava_next, "project_image_features", counted)
    got = _run(psteer.SteeringController, sae, model, proc, FEATURES, fbs, image=image_path, hook="model.layers.1")
    assert got == ref
    n_generates = 1 + -(-len(FEATURES) // fbs)
    assert len(calls) == n_generates and len(set(calls)) == 1, calls


def test_batched_equals_sequential(text_subject, sae_pairs):
    """Five features in one chunk give the dict of five chunks of one."""
    _, model = text_subject
    _, sae = sae_pairs["32768"]
    tok = FakeTokenizer()
    assert _run(psteer.SteeringController, sae, model, tok, FEATURES, 5) == \
        _run(psteer.SteeringController, sae, model, tok, FEATURES, 1)


def test_controller_eos_from_tokenizer(text_subject, sae_pairs):
    """With no stop id in the generation config, the tokenizer's applies:
    the baseline's step-2 token as the stop id ends it there (the tail is
    the stop id), on both sides alike."""
    jmodel, model = text_subject
    jsae, sae = sae_pairs["1024"]
    free = _run(psteer.SteeringController, sae, model, FakeTokenizer(), FEATURES[:2], 2)
    stop = int(free["layers.1_feature3"]["original_resps"].split()[2])
    tok = FakeTokenizer(eos_token_id=stop)
    ref = _run(jsteer.SteeringController, jsae, jmodel, tok, FEATURES[:2], 2)
    got = _run(psteer.SteeringController, sae, model, tok, FEATURES[:2], 2)
    assert got == ref
    baseline = got["layers.1_feature3"]["original_resps"].split()
    assert baseline[2:] == [str(stop)] * (NEW - 2)


def test_controller_sampling_config(text_subject, sae_pairs):
    """A sampling config: the keys and indices equal the JAX controller's,
    every entry carries the one baseline, and the same seed gives the same
    dict again (the sampled text itself is not compared: JAX's threefry
    draws have no PyTorch counterpart)."""
    jmodel, model = text_subject
    jsae, sae = sae_pairs["1024"]
    cfg = {"do_sample": True, "temperature": 0.7, "top_p": 0.9, "seed": 3}
    ref = _run(jsteer.SteeringController, jsae, jmodel, FakeTokenizer(), FEATURES, 3, generation_config=cfg)
    got = _run(psteer.SteeringController, sae, model, FakeTokenizer(), FEATURES, 3, generation_config=cfg)
    assert list(got) == list(ref)
    assert [r["idx"] for r in got.values()] == [r["idx"] for r in ref.values()]
    assert len({r["original_resps"] for r in got.values()}) == 1
    assert got == _run(psteer.SteeringController, sae, model, FakeTokenizer(), FEATURES, 3, generation_config=cfg)


@pytest.mark.parametrize("temperature", [0.0, -0.5])
def test_controller_rejects_non_positive_temperature(text_subject, sae_pairs, temperature):
    jmodel, model = text_subject
    jsae, sae = sae_pairs["1024"]
    cfg = {"do_sample": True, "temperature": temperature}
    for cls, s, m in ((jsteer.SteeringController, jsae, jmodel), (psteer.SteeringController, sae, model)):
        with pytest.raises(ValueError, match="temperature"):
            _run(cls, s, m, FakeTokenizer(), FEATURES, 1, generation_config=cfg)


def test_load_generation_config_matches_jax(tmp_path):
    from multimodal_sae_tpu.launch import utils as jutils
    from multimodal_sae_tpu_torch.launch import utils as putils

    assert putils._load_generation_config(str(tmp_path)) == jutils._load_generation_config(str(tmp_path)) == {}
    (tmp_path / "generation_config.json").write_text(json.dumps(
        {"do_sample": True, "temperature": 0.6, "top_p": None, "eos_token_id": [128001, 128009], "max_length": 9}))
    got = putils._load_generation_config(str(tmp_path))
    assert got == jutils._load_generation_config(str(tmp_path))
    assert got == {"do_sample": True, "temperature": 0.6, "eos_token_id": [128001, 128009]}


@pytest.mark.parametrize("with_image", [False, True], ids=["text", "image"])
def test_prepare_prompt_batch_matches_jax(image_subject, with_image):
    from torch_llava_tiny import IMG_TOKEN, images

    from multimodal_sae_tpu.launch import utils as jutils
    from multimodal_sae_tpu_torch.launch import utils as putils

    jmodel, model = image_subject
    tok = FakeTokenizer(image_token=IMG_TOKEN)
    image = images([(40, 60)])[0] if with_image else None
    jt, jids, jbatch = jutils.prepare_prompt_batch(jmodel, FakeProcessor(tok), tok, "hi", image=image)
    pt, pids, pbatch = putils.prepare_prompt_batch(model, FakeProcessor(tok), tok, "hi", image=image)
    assert jt is pt is tok and pids == jids
    assert set(pbatch) == set(jbatch)
    for key in ("input_ids", "attention_mask"):
        if key in jbatch:
            np.testing.assert_array_equal(np.asarray(pbatch[key]), np.asarray(jbatch[key]))
    raw = putils.prepare_prompt_batch(model, None, tok, None, use_chat_template=False, raw_prompt="abc")
    assert raw[1] == jutils.prepare_prompt_batch(jmodel, None, tok, None, use_chat_template=False,
                                                 raw_prompt="abc")[1]


ROOTS = {"jax": "multimodal_sae_tpu", "port": "multimodal_sae_tpu_torch"}


@pytest.fixture
def cli_setup(tmp_path, monkeypatch, text_subject):
    """Both CLIs' `load_subject_model` pinned to the tiny text subject, a
    JAX-saved SAE directory (layers.1, width 1,024) and a filter of 5
    features."""
    jmodel, model = text_subject
    jsae, _ = _saes(1024, 8)
    jsae.save_to_disk(str(tmp_path / "saes" / "layers.1"))
    (tmp_path / "filters.json").write_text(json.dumps({"layers.1": FEATURES}))
    tok = FakeTokenizer()
    monkeypatch.setattr(importlib.import_module(f"{ROOTS['jax']}.launch.features.steering"), "load_subject_model",
                        lambda *a, **kw: (jmodel, None, tok))
    monkeypatch.setattr(importlib.import_module(f"{ROOTS['port']}.launch.features.steering"), "load_subject_model",
                        lambda *a, **kw: (model, None, tok))
    return tmp_path


def _cli_args(tmp, out, *extra):
    return ["--model", "tiny", "--text", "hi there", "--sae-path", str(tmp / "saes"), "--filters",
            str(tmp / "filters.json"), "--save-dir", str(out), "--max-new-tokens", str(NEW),
            "--feature-batch-size", "3", *extra]


def test_steering_cli_matches_jax_byte_for_byte(cli_setup, monkeypatch):
    from multimodal_sae_tpu.launch.features import steering as jax_cli
    from multimodal_sae_tpu_torch.launch.features import steering as port_cli

    tmp = cli_setup
    monkeypatch.setattr(sys, "argv", ["steering", *_cli_args(tmp, tmp / "jax")])
    jax_cli.main()
    port_cli.main(_cli_args(tmp, tmp / "port"), device="cpu")
    want = (tmp / "jax" / "layers.1.json").read_bytes()
    assert (tmp / "port" / "layers.1.json").read_bytes() == want
    assert len(json.loads(want)) == len(FEATURES)


@pytest.mark.parametrize("flag", ["--load-in-8bit", "--int8-matmul", "--int8-vision"])
def test_steering_cli_passes_the_int8_flags_on(cli_setup, flag, monkeypatch):
    from multimodal_sae_tpu_torch.launch.features import steering as port_cli

    loaded = []

    def stop(*args, **kw):
        loaded.append(kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(port_cli, "load_subject_model", stop)
    with pytest.raises(KeyboardInterrupt):
        port_cli.main(_cli_args(cli_setup, cli_setup / "port", flag), device="cpu")
    ((kw,),) = [loaded]
    names = {"--load-in-8bit": "load_in_8bit", "--int8-matmul": "int8_matmul", "--int8-vision": "int8_vision"}
    assert {name: kw[name] for name in names.values()} == {name: f == flag for f, name in names.items()}
    assert kw["flash_attention"]  # bf16, the default dtype, and a quantised subject's


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--dp", "2"]])
def test_steering_cli_refuses_unported_flags(cli_setup, flag, monkeypatch, tmp_path):
    """--tp and --dp are ported: the CLI hands them to `load_subject_model`,
    which refuses --tp 2 in a world of one process and --dp 2 without two
    cards."""
    from multimodal_sae_tpu_torch.launch import utils as launch_utils
    from multimodal_sae_tpu_torch.launch.features import steering as port_cli
    from torch_tp_tiny import write_checkpoint

    ckpt = write_checkpoint(tmp_path / "ckpt")
    monkeypatch.setattr(port_cli, "load_subject_model", lambda _, **kw: launch_utils.load_subject_model(ckpt, **kw))
    message = {"--tp": "world size it divides", "--dp": "local devices"}[flag[0]]
    with pytest.raises(ValueError, match=message):
        port_cli.main(_cli_args(cli_setup, cli_setup / "port", *flag), device="cpu")
    assert not (cli_setup / "port").exists()


class StubClient:
    """The judge: a rating from each request's length, so that replies
    differ by feature."""

    def __init__(self, *args, **kwargs):
        self.cleaned = False

    async def generate(self, prompt, **kwargs):
        return str(1 + len(prompt) % 4)

    def clean(self):
        self.cleaned = True


def test_filter_steering_cli_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    from multimodal_sae_tpu.launch.features import filter_steering as jax_cli
    from multimodal_sae_tpu_torch.launch.features import filter_steering as port_cli

    for root in ROOTS.values():
        monkeypatch.setattr(importlib.import_module(f"{root}.launch.features.filter_steering"), "SRT", StubClient)
    result = {f"layers.1_feature{f}": {"original_resps": "a b c", "clamped_resps": "x " * (f % 7), "idx": f}
              for f in FEATURES}
    (tmp_path / "explanations").mkdir()
    (tmp_path / "explanations" / "layers.1.json").write_text(json.dumps(
        [{"layers.1_feature3": "cats", "prompt": "p"}, {"layers.1_feature250": "dogs é", "prompt": "p"}]))
    for side in ROOTS:
        (tmp_path / f"{side}.json").write_text(json.dumps(result))
    monkeypatch.setattr(sys, "argv", ["filter", "-e", str(tmp_path / "explanations"), "-s", str(tmp_path / "jax.json")])
    jax_cli.main()
    port_cli.main(["-e", str(tmp_path / "explanations"), "-s", str(tmp_path / "port.json")])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    labelled = json.loads(want)
    assert labelled["layers.1_feature250"]["explanation"] == "dogs é"
    assert all("category" in entry for entry in labelled.values())


def test_generation_and_steering_turn_tf32_off(text_subject, sae_pairs):
    """The clamp's encoder is fp32: `greedy_generate`, the clamp functions
    and `SteeringController` each call `set_precision()`, as the JAX side
    runs the encoder at HIGHEST precision."""
    from multimodal_sae_tpu_torch.models.llama import greedy_generate

    _, model = text_subject
    _, sae = sae_pairs["1024"]
    calls = (
        lambda: greedy_generate(model.params, model.cfg, np.array([[1, 2, 3]]), 1),
        lambda: psteer.clamp_features_max(sae, 3),
        lambda: psteer.clamp_features_max_batched(sae, [3]),
        lambda: psteer.SteeringController(sae, "layers.1", [3], model, FakeTokenizer(), "hi"),
    )
    try:
        for call in calls:
            torch.backends.cuda.matmul.allow_tf32 = True
            call()
            assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
