"""The helpers that close the port's named list of missing exports
(tests/test_torch_imports.py): `utils.maybe_trace` and `utils.timed`
(multimodal_sae_tpu/utils/profiling.py) beside the JAX package's,
`interp_utils.load_tokenizer` (JAX :133) and `native.native_available`
(JAX native/coo.py:137), and the trainer's `fit` inside
`maybe_trace("sae_train")` (JAX train/trainer.py:494-496)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _traced(maybe_trace, log_dir=None):
    with maybe_trace("span", log_dir=log_dir):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_maybe_trace_writes_only_with_a_directory(package, tmp_path, monkeypatch):
    """Neither package writes without `MMSAE_PROFILE_DIR` (or `log_dir`);
    with it, each writes its trace under `{dir}/{name}/`, the port a Chrome
    trace per rank that names the traced operators."""
    if package == "jax":
        from multimodal_sae_tpu.utils import maybe_trace
    else:
        from multimodal_sae_tpu_torch.utils import maybe_trace
    monkeypatch.delenv("MMSAE_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    _traced(maybe_trace)
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("MMSAE_PROFILE_DIR", str(tmp_path / "env"))
    _traced(maybe_trace)
    _traced(maybe_trace, log_dir=str(tmp_path / "arg"))
    for d in ("env", "arg"):
        files = [p for p in (tmp_path / d / "span").rglob("*") if p.is_file()]
        assert files, d
    if package == "port":
        trace = json.loads((tmp_path / "env" / "span" / "rank0.trace.json").read_text())
        assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])


@pytest.mark.parametrize("sink", [False, True], ids=["stdout", "sink"])
def test_timed_reports_like_the_jax_helper(sink, capsys):
    from multimodal_sae_tpu.utils import timed as jax_timed
    from multimodal_sae_tpu_torch.utils import timed

    got = {}
    for name, helper in (("jax", jax_timed), ("port", timed)):
        spans = []
        with helper("step", sink=(lambda label, s: spans.append((label, s))) if sink else None):
            pass
        got[name] = spans if sink else capsys.readouterr().out
    if sink:
        assert [label for label, _ in got["port"]] == [label for label, _ in got["jax"]] == ["step"]
        assert 0 <= got["port"][0][1] < 1
    else:
        assert got["port"].startswith("[timing] step: ") and got["port"].endswith("s\n")
        assert len(got["port"]) == len(got["jax"])


def test_load_tokenizer_pads_left_with_eos(tmp_path):
    from multimodal_sae_tpu.interp_utils import load_tokenizer as jax_load_tokenizer
    from multimodal_sae_tpu_torch.interp_utils import load_tokenizer
    from torch_tp_tiny import EOS, write_checkpoint

    ckpt = write_checkpoint(tmp_path / "ckpt")
    tok, jax_tok = load_tokenizer(ckpt), jax_load_tokenizer(ckpt)
    assert tok.padding_side == "left" and tok.pad_token == tok.eos_token == str(EOS)
    enc = tok(["1 2 3", "4"], padding=True)
    assert enc["input_ids"] == [[1, 2, 3], [EOS, EOS, 4]] and enc["attention_mask"][1] == [0, 0, 1]
    assert enc == jax_tok(["1 2 3", "4"], padding=True)


def test_native_available_follows_the_switch():
    """Read at each call, as the port's COO paths read it (PR 11's fault
    fix); the JAX helper, which reads it once a process, agrees in a fresh
    process either way."""
    code = ("import os\n"
            "from multimodal_sae_tpu_torch.native import native_available\n"
            "from multimodal_sae_tpu.native import native_available as jax_native_available\n"
            "jax_first = jax_native_available()\n"
            "first = native_available()\n"
            "os.environ['MMSAE_DISABLE_NATIVE'] = '1'\n"
            "off = native_available()\n"
            "del os.environ['MMSAE_DISABLE_NATIVE']\n"
            "print(jax_first, first, off, native_available())\n")
    out = {}
    for flag in ("0", "1"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(MMSAE_DISABLE_NATIVE=flag, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        out[flag] = r.stdout.split()
    # Built with g++ here: available unless switched off, the JAX helper alike.
    assert out["0"] == ["True", "True", "False", "True"]
    assert out["1"] == ["False", "False", "False", "True"]


def test_trainer_fit_writes_the_sae_train_trace(tmp_path, monkeypatch):
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.models import SyntheticActivationSource
    from multimodal_sae_tpu_torch.train import SaeTrainer

    monkeypatch.setenv("MMSAE_PROFILE_DIR", str(tmp_path / "prof"))
    rows = [{"input_ids": r} for r in np.random.default_rng(0).integers(0, 64, size=(8, 8))]
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4), batch_size=4, hookpoints=["layers.1"],
                      log_to_wandb=False, run_name=str(tmp_path / "run"), save_every=10_000)
    SaeTrainer(cfg, rows, SyntheticActivationSource(d_model=16, n_layers=2, vocab=64, device="cpu"),
               device="cpu").fit()
    trace = json.loads((tmp_path / "prof" / "sae_train" / "rank0.trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::topk") for e in trace["traceEvents"])
    assert (tmp_path / "run" / "state.json").exists()
