"""The PyTorch port's `SaeTrainer` and its CLI against the JAX package's.

Both trainers run on the same `SyntheticActivationSource` (the port's takes
the JAX source's `embed`) from the same parameters (the JAX trainer's,
carried by `convert.py`), over one grad-acc boundary and more, with micro
chunks, the b_dec init at step 0 and a dead-feature threshold low enough
that AuxK runs.  Tolerances:

* dead-feature counters, the windows' fired masks and the step counters:
  exactly equal;
* parameters: within 1e-2 * lr.  The first Adam step is about lr * sign(g),
  so a gradient element near float noise could flip and move a parameter
  by 2 * lr; this bound admits only fp32 noise.  The gradients themselves
  are held to rtol 1e-5 in tests/test_torch_sae_forward.py and the
  optimizer on identical gradients in tests/test_torch_train_ops.py;
* the fvu and AuxK metrics: rtol 1e-5;
* checkpoints: `config.json`, `state.json` and each `cfg.json` equal as
  text; every safetensors file with the same keys, dtypes and shapes; a
  checkpoint written by either package resumed by the other with every
  parameter, optimizer leaf and counter equal bit for bit, then one more
  batch on both within the parameter bound.
The CLI trains on `synthetic://` and a `.bin` file on the CPU and writes
the JAX CLI's `config.json` for the same flags; the flags this slice does
not serve raise with a pointer to ROADMAP.md."""

import json
import os
import sys

import numpy as np
import pytest

import jax
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.config import TrainConfig as JaxTrainConfig
from multimodal_sae_tpu.models import SyntheticActivationSource as JaxSource
from multimodal_sae_tpu.parallel import get_mesh
from multimodal_sae_tpu.train import SaeTrainer as JaxTrainer
from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.features.cache import _collate
from multimodal_sae_tpu_torch.models import SyntheticActivationSource
from multimodal_sae_tpu_torch.ops.adam import flatten_state
from multimodal_sae_tpu_torch.train import SaeTrainer
from multimodal_sae_tpu_torch.utils.safetensors_io import read_header

HOOK = "layers.1"
LR = 1e-3
PARAM_ATOL = 1e-2 * LR
RTOL = 1e-5
BATCH, SEQ, VOCAB, D = 4, 8, 64, 16


def _cfg_kwargs(run_name=None, adam_8bit=False):
    return dict(batch_size=BATCH, grad_acc_steps=2, micro_acc_steps=2, lr=LR, lr_warmup_steps=0,
                auxk_alpha=1 / 32, dead_feature_threshold=40, adam_8bit=adam_8bit, log_to_wandb=False,
                save_every=10_000, hookpoints=[HOOK], run_name=run_name)


def _dataset(n=40, seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, size=(n, SEQ))
    return [{"input_ids": row} for row in ids]


def _batch(ds, i):
    return _collate(ds[i * BATCH:(i + 1) * BATCH])


def _jax_trainer(ds, src, **kw):
    cfg = JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=16, k=4), **_cfg_kwargs(**kw))
    return JaxTrainer(cfg, ds, src, mesh=get_mesh(("data",), devices=jax.devices()[:1]))


def _torch_trainer(ds, jsrc, **kw):
    src = SyntheticActivationSource(d_model=D, n_layers=2, vocab=VOCAB, embed=np.asarray(jsrc.embed), device="cpu")
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=16, k=4), **_cfg_kwargs(**kw))
    return SaeTrainer(cfg, ds, src, device="cpu")


def _carry(jt, tt):
    """The JAX trainer's initial parameters into the port's trainer."""
    params = sae_params_from_jax({k: np.asarray(v) for k, v in jt.saes[HOOK].params.items()}, device="cpu")
    with torch.no_grad():
        for name, t in params.items():
            tt.saes[HOOK].params[name].copy_(t)


def _pair(**kw):
    ds = _dataset()
    jsrc = JaxSource(d_model=D, n_layers=2, vocab=VOCAB)
    jt, tt = _jax_trainer(ds, jsrc, **kw), _torch_trainer(ds, jsrc, **kw)
    _carry(jt, tt)
    return ds, jt, tt


def _state(trainer):
    """(params, optimizer leaves, counters, (global_step, opt_step)) as numpy."""
    if isinstance(trainer, SaeTrainer):
        params = {k: v.detach().numpy() for k, v in trainer.saes[HOOK].params.items()}
        leaves = [t.numpy() for t in flatten_state(trainer.opt_states[HOOK])]
    else:
        params = {k: np.asarray(v) for k, v in trainer.saes[HOOK].params.items()}
        leaves = [np.asarray(a) for a in jax.tree_util.tree_flatten(trainer.opt_states[HOOK])[0]]
    return params, leaves, trainer.num_tokens_since_fired[HOOK].copy(), (trainer.global_step, trainer.opt_step)


def _assert_params_close(jt, tt):
    jp, _, _, _ = _state(jt)
    tp, _, _, _ = _state(tt)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_trainers_match_step_by_step():
    """8 batches: 4 optimizer steps, micro chunks, b_dec init, AuxK."""
    from collections import defaultdict

    ds, jt, tt = _pair()
    dead_seen = 0
    for i in range(8):
        had_dead = bool((tt.num_tokens_since_fired[HOOK] > 40).any())
        jm, tm = {HOOK: defaultdict(float)}, {HOOK: defaultdict(float)}
        jt.step(_batch(ds, i), jm)
        tt.step(_batch(ds, i), tm)
        if i == 0:
            np.testing.assert_allclose(tt.saes[HOOK].b_dec.detach().numpy(),
                                       np.asarray(jt.saes[HOOK].params["b_dec"]), rtol=1e-5, atol=1e-6)
        for key in ("fvu", "auxk"):
            np.testing.assert_allclose(tm[HOOK][key], jm[HOOK][key], rtol=RTOL, atol=1e-7)
        np.testing.assert_array_equal(tt.num_tokens_since_fired[HOOK], jt.num_tokens_since_fired[HOOK])
        if i % 2 == 0:  # inside a window: the fired masks OR-ed so far
            np.testing.assert_array_equal(tt._fired_dev[HOOK].numpy(), np.asarray(jt._fired_dev[HOOK]))
        assert (tt.global_step, tt.opt_step) == (jt.global_step, jt.opt_step)
        _assert_params_close(jt, tt)
        assert (tm[HOOK]["auxk"] > 0) == had_dead
        dead_seen += had_dead
    assert dead_seen > 0, "no latent went dead: AuxK never ran"


def _headers(path):
    out = {}
    for root, _, files in os.walk(path):
        for f in sorted(files):
            full = os.path.join(root, f)
            rel = os.path.relpath(full, path)
            if f.endswith(".safetensors"):
                header, _ = read_header(full)
                out[rel] = {k: (v["dtype"], v["shape"]) for k, v in header.items()}
            else:
                out[rel] = open(full).read()
    return out


def _run_and_save(trainer, ds, n, path):
    for i in range(n):
        trainer.step(_batch(ds, i))
    trainer.cfg.run_name = str(path)
    trainer.save()


@pytest.mark.parametrize("adam_8bit", [False, True], ids=["adam", "adam8bit"])
def test_checkpoint_files_match(tmp_path, adam_8bit):
    """config.json, state.json and cfg.json text-equal; safetensors keys,
    dtypes and shapes equal (8-bit: W_enc and W_dec, 4,096 elements each,
    hold 8-bit moments)."""
    ds, jt, tt = _pair(adam_8bit=adam_8bit)
    _run_and_save(jt, ds, 4, tmp_path / "jax")
    _run_and_save(tt, ds, 4, tmp_path / "torch")
    # The run names differ by construction; everything else is equal.
    jax_files = _headers(tmp_path / "jax")
    torch_files = _headers(tmp_path / "torch")
    assert jax_files.keys() == torch_files.keys()
    for name in jax_files:
        want, got = jax_files[name], torch_files[name]
        if name == "config.json":
            want, got = json.loads(want), json.loads(got)
            assert want.pop("run_name") != got.pop("run_name")
            assert json.dumps(want) == json.dumps(got)
        else:
            assert got == want, name
    assert ("I8" in str(jax_files["optimizer_layers_1.safetensors"])) == adam_8bit


@pytest.mark.parametrize("adam_8bit", [False, True], ids=["adam", "adam8bit"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_across_packages(tmp_path, direction, adam_8bit):
    ds, jt, tt = _pair(adam_8bit=adam_8bit)
    jsrc = JaxSource(d_model=D, n_layers=2, vocab=VOCAB)
    writer, path = (jt, tmp_path / "ck") if direction == "jax_to_torch" else (tt, tmp_path / "ck")
    _run_and_save(writer, ds, 4, path)  # at a grad-acc boundary, as `fit` stops
    reader = _torch_trainer(ds, jsrc, adam_8bit=adam_8bit) if direction == "jax_to_torch" else \
        _jax_trainer(ds, jsrc, adam_8bit=adam_8bit)
    reader.load_state(str(path))
    wp, wl, wc, ws = _state(writer)
    rp, rl, rc, rs = _state(reader)
    assert ws == rs == (4, 2)
    np.testing.assert_array_equal(rc, wc)
    for name in wp:
        assert rp[name].dtype == wp[name].dtype and rp[name].tobytes() == wp[name].tobytes(), name
    assert len(rl) == len(wl)
    for a, b in zip(rl, wl):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # One more window on both stays within the bound.
    for i in (4, 5):
        writer.step(_batch(ds, i))
        reader.step(_batch(ds, i))
    jt2, tt2 = (writer, reader) if direction == "jax_to_torch" else (reader, writer)
    _assert_params_close(jt2, tt2)
    np.testing.assert_array_equal(tt2.num_tokens_since_fired[HOOK], jt2.num_tokens_since_fired[HOOK])


def _bin(tmp_path, n=24, seq=8):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, VOCAB, size=(n, seq)).astype(np.uint16).tofile(path)
    return str(path)


def _cli_args(tmp_path, run_name, *extra):
    return ["synthetic://16,2,64", _bin(tmp_path), "--hookpoints", HOOK, "--batch_size", "4", "--ctx_len", "8",
            "--expansion_factor", "4", "--k", "4", "--lr_warmup_steps", "0", "--grad_acc_steps", "2",
            "--no_log_to_wandb", "--run_name", str(tmp_path / run_name), *extra]


def test_cli_trains_and_writes_the_jax_clis_config(tmp_path, monkeypatch):
    from multimodal_sae_tpu import __main__ as jax_main
    from multimodal_sae_tpu_torch.__main__ import run

    trainer = run(_cli_args(tmp_path, "torch_run"), device="cpu")
    assert trainer.global_step == 6 and trainer.opt_step == 3
    monkeypatch.setattr(sys, "argv", ["sae", *_cli_args(tmp_path, "jax_run")])
    jax_main.run()
    for f in ("state.json", "config.json", f"{HOOK}/cfg.json"):
        want = open(tmp_path / "jax_run" / f).read().replace("jax_run", "torch_run")
        assert open(tmp_path / "torch_run" / f).read() == want, f
    assert sorted(os.listdir(tmp_path / "torch_run")) == sorted(os.listdir(tmp_path / "jax_run"))


def test_cli_resumes_its_checkpoint(tmp_path):
    from multimodal_sae_tpu_torch.__main__ import run

    first = run(_cli_args(tmp_path, "run"), device="cpu")
    again = run(_cli_args(tmp_path, "run", "--resume"), device="cpu")
    assert again.global_step == first.global_step  # resumed at the end: nothing left to train
    for name, t in first.saes[HOOK].params.items():
        assert torch.equal(again.saes[HOOK].params[name], t)


def test_cli_help_says_the_threshold_is_exact(capsys):
    from multimodal_sae_tpu_torch.__main__ import run

    with pytest.raises(SystemExit):
        run(["--help"], device="cpu")
    assert "exact" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--dp", "2"], ["--load_in_8bit"], ["--int8_matmul"],
                                  ["--int8_vision"], ["--mm_data"], ["--distribute_modules"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_unported_flags(tmp_path, flag):
    from multimodal_sae_tpu_torch.__main__ import run

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run(_cli_args(tmp_path, "run", *flag), device="cpu")
    assert not (tmp_path / "run").exists()


def test_trainer_and_cli_turn_tf32_off(tmp_path):
    from multimodal_sae_tpu_torch.__main__ import run

    ds = _dataset(8)
    src = SyntheticActivationSource(d_model=D, n_layers=2, vocab=VOCAB, device="cpu")
    for call in (lambda: SaeTrainer(TrainConfig(**_cfg_kwargs()), ds, src, device="cpu"),
                 lambda: run(_cli_args(tmp_path, "run"), device="cpu")):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        call()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
