"""The port's explain and score CLIs against the JAX package's: `explain`,
`score`, `explain_images`, `image_activations` and `clip_score`, each
`main` run by both packages on its own copy of one numpy-seeded cache (the
loader heals sidecars into the directory it scans).

The fakes are the JAX tests': a stub LLM client in place of `SRT`, a
character-level tokenizer with the slow-tokenizer overflow layout that
`chunk_and_tokenize` expects, a `datasets.Dataset` built in memory in place
of `load_dataset`, a processor that only names its image-token count, and a
CLIP metric computed from the pixels and the text.  Every file the CLIs
write must be byte-equal between the packages; no float is computed apart
from the shared numpy and PIL code, so no tolerance."""

import importlib
import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import datasets
import transformers
from PIL import Image

from multimodal_sae_tpu_torch.utils.safetensors_io import save_file

MODULE = "layers.1"
WIDTH, N_SPLITS, CTX = 64, 2, 8
ROOTS = {"jax": "multimodal_sae_tpu", "port": "multimodal_sae_tpu_torch"}


class StubClient:
    def __init__(self, reply):
        self.reply, self.calls, self.cleaned = reply, [], False

    async def generate(self, prompt, **kwargs):
        self.calls.append(prompt)
        return self.reply

    def clean(self):
        self.cleaned = True


class CharTokenizer:
    """One id per character; the overflow comes back flat, as a slow
    tokenizer returns it."""

    model_max_length = 10**6
    eos_token = "\n"

    def __call__(self, text, max_length, return_attention_mask, return_overflowing_tokens, truncation):
        ids = [ord(c) % 97 + 1 for c in text]
        return {"input_ids": ids[:max_length], "overflowing_tokens": ids[max_length:]}

    def batch_decode(self, token_lists, **kw):
        return [chr(int(t[0]) + 31) for t in token_lists]


TEXTS = ["the cat sat on the mat", "a dog ran far away", "widgets and gadgets"] * 6


def _write_cache(path, rows, seq, seed):
    """Two splits of COO triples over `rows` x `seq` positions, every
    feature present at least twice."""
    rng = np.random.default_rng(seed)
    n = 600
    loc = np.stack([rng.integers(0, rows, n), rng.integers(0, seq, n), rng.integers(0, WIDTH, n)], 1)
    loc = np.unique(loc, axis=0).astype(np.int64)
    act = rng.uniform(0.1, 5.0, len(loc)).astype(np.float32)
    os.makedirs(path / MODULE)
    half = WIDTH // N_SPLITS
    for s in range(N_SPLITS):
        m = (loc[:, 2] >= s * half) & (loc[:, 2] < (s + 1) * half)
        save_file({"locations": loc[m], "activations": act[m]},
                  str(path / MODULE / f"{s * half}_{(s + 1) * half - 1}.safetensors"))


def _tree(d):
    return {os.path.relpath(os.path.join(r, f), d): open(os.path.join(r, f), "rb").read()
            for r, _, files in os.walk(d) for f in files}


@pytest.fixture
def world(tmp_path, monkeypatch):
    """Patches both packages' CLIs share; returns the stub clients made."""
    made = []

    def srt(model, **kw):
        reply = "[EXPLANATION]: mentions of widgets" if "405B" in model or "onevision" in model else (
            "scores: [3, 2, 0, 1, 3]" if "70B" in model else "[ANSWER] Widgets")
        made.append(StubClient(reply))
        return made[-1]

    images = [Image.fromarray(np.random.default_rng(i).integers(0, 255, (20 + i, 24, 3), dtype=np.uint8))
              for i in range(6)]
    text_ds = datasets.Dataset.from_dict({"text": TEXTS})
    image_ds = datasets.Dataset.from_dict({"image": images, "id": [0, 1, 1, 2, 3, 4]})
    monkeypatch.setattr(datasets, "load_dataset", lambda name, split: image_ds if name == "images" else text_ds)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda name: CharTokenizer())
    monkeypatch.setattr(transformers.AutoProcessor, "from_pretrained",
                        lambda name: SimpleNamespace(num_image_tokens=16))
    for root in ROOTS.values():
        for cli in ("launch.explain.explain", "launch.explain.explain_images", "launch.score.score",
                    "launch.score.clip_score"):
            monkeypatch.setattr(importlib.import_module(f"{root}.{cli}"), "SRT", srt)
    return SimpleNamespace(made=made, tmp=tmp_path)


def _args(pkg, cache, out, *extra):
    utils = importlib.import_module(f"{ROOTS[pkg]}.launch.utils")
    return utils.parse_feature_experiment([
        "--save_dir", str(cache), "--explanation_dir", str(out / "explanations"), "--scores_dir",
        str(out / "scores"), "--width", str(WIDTH), "--n_splits", str(N_SPLITS), "--example_ctx_len", str(CTX),
        "--min_examples", "1", "--max_examples", "100", "--n_examples_train", "4", *extra])


def _cli(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.launch.{name}")


def test_explain_then_score_write_the_same_files(world):
    tokens_rows = len("".join("\n" + t for t in TEXTS)) // CTX - 1
    out = {}
    for pkg in ROOTS:
        cache, run = world.tmp / pkg / "cache", world.tmp / pkg
        _write_cache(cache, tokens_rows, CTX, seed=0)
        args = _args(pkg, cache, run, "--model", "char", "--dataset", "text")
        _cli(pkg, "explain.explain").main(args)
        _cli(pkg, "score.score").main(args)
        out[pkg] = {k: v for k, v in _tree(run).items() if not k.startswith("cache")}
    assert out["port"] == out["jax"]
    names = sorted(out["port"])
    assert "explanations/layers_1.json" in names
    assert sum(n.startswith("scores/layers_1/") for n in names) == len(json.loads(
        out["port"]["explanations/layers_1.json"])) > 10
    assert all(c.cleaned for c in world.made) and len(world.made) == 4


def _image_cache(path, seed):
    rng = np.random.default_rng(seed)
    n = 300
    loc = np.stack([rng.integers(0, 6, n), rng.integers(0, 16, n), rng.integers(0, WIDTH, n)], 1)
    loc = np.unique(loc, axis=0).astype(np.int64)
    act = rng.uniform(0.1, 5.0, len(loc)).astype(np.float32)
    os.makedirs(path / MODULE)
    half = WIDTH // N_SPLITS
    for s in range(N_SPLITS):
        m = (loc[:, 2] >= s * half) & (loc[:, 2] < (s + 1) * half)
        save_file({"locations": loc[m], "activations": act[m]},
                  str(path / MODULE / f"{s * half}_{(s + 1) * half - 1}.safetensors"))


def test_image_explain_activations_and_clip_score_write_the_same_files(world, monkeypatch):
    def metric(image, text):
        return float(np.asarray(image, dtype=np.float64).mean()) / 3 + len(text)

    out = {}
    for pkg in ROOTS:
        run = world.tmp / pkg
        _image_cache(run / "cache", seed=1)
        # Four features: every image written is PNG- or JPEG-encoded on both sides.
        (run / "filters.json").write_text(json.dumps({MODULE: [3, 17, 40, 50]}))
        args = _args(pkg, run / "cache", run, "--model", "llava", "--dataset", "images", "--max_examples", "3",
                     "--n_examples_train", "3", "--filters_path", str(run / "filters.json"))
        _cli(pkg, "explain.explain_images").main(args)
        _cli(pkg, "features.image_activations").main(args)
        monkeypatch.setattr(importlib.import_module(f"{ROOTS[pkg]}.agents.scorers.clip.clip_scorer"),
                            "torchmetrics_clip_metric", lambda name, device: metric)
        monkeypatch.setattr(sys, "argv", ["clip_score", "--explanation_dir", str(run / "explanations"),
                                          "--save-refine-path", str(run / "refined.json"),
                                          "--save-score-path", str(run / "clip" / "scores.json")])
        _cli(pkg, "score.clip_score").main()
        shutil.rmtree(run / "cache")
        out[pkg] = _tree(run)
    assert out["port"] == out["jax"]
    scores = json.loads(out["port"]["clip/scores.json"])
    assert len(scores) == 4 and all(s["k"] == 3 and s["label"] == "Widgets" for s in scores)
    assert any(n.startswith("explanations/images/layers_1/") and n.endswith("activated_examples_0.jpg")
               for n in out["port"])
