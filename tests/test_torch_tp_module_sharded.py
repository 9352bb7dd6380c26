"""Module-sharded training under tensor parallelism (`--distribute_modules`
with `--tp 2`, train/module_sharded.py and train/trainer.py) on the CPU
over gloo, on the tiny LLaMA of tests/torch_tp_tiny.py in fp32 with its
captures on the drivers' grid (tests/torch_mp_drivers/mp_tp.py's `train`
mode: the training CLI, two hookpoints).

Under `--tp 2` every rank of a TP group holds the group's hidden states,
so the plan shards the hookpoints over the group's two ranks and no row
moves; the ranks that share `rank % 2` train the same hookpoint
data-parallel.

* Two ranks (one TP group): each rank trains one hookpoint, and every file
  of the checkpoint but `config.json` equals the `--tp 2` trainer's byte
  for byte (the same operations on the same hidden states).  SIGTERM to
  rank 1 alone stops both ranks at one grad-acc boundary with a
  checkpoint, from which `--resume` ends with the uninterrupted run's
  files, byte for byte; a world-1 trainer of either package resumes the
  checkpoint with every parameter equal.
* Four ranks (two TP groups): equal to the same four ranks without the
  flag within TOL, test_torch_module_sharded.py's bound (the data-parallel
  sums over the ranks that share `rank % 2` are the same in both runs).
* Both against the JAX trainer on the same grid captures, from the port's
  initial parameters: within TOL, test_torch_tp.py's training bound.
Each rank driver runs under a 240 s group timeout and is killed at 300 s.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu_torch.sae import Sae
from multimodal_sae_tpu_torch.train.module_sharded import module_plan
from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

from torch_mp import start_ranks, wait_all
from torch_tp_tiny import write_checkpoint

HOOKS = ["layers.1", "layers.2"]
FLAGS = ["--hookpoints", *HOOKS, "--batch_size", "2", "--grad_acc_steps", "2", "--lr_warmup_steps", "1",
         "--expansion_factor", "4", "--k", "4", "--ctx_len", "8", "--no_log_to_wandb", "--save_every", "10000"]
TOL = dict(rtol=1e-5, atol=1e-6)
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The training CLI at --tp 2: two ranks without and with the flag, and
    preempted then resumed; four ranks without and with it; all six
    processes at once.  Returns (directory, {world: outputs})."""
    from datasets import Dataset

    d = tmp_path_factory.mktemp("tp_modules")
    ckpt = write_checkpoint(d / "ckpt")
    ids = np.random.default_rng(5).integers(1, 255, size=(16, 8))
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(d / "ds"))
    procs = {world: start_ranks("mp_tp.py", ["train", ckpt, d / "ds", d / f"w{world}", runs, *FLAGS], world=world)
             for world, runs in ((2, "tp,dm,resumed"), (4, "tp,dm"))}
    outs = {}
    for world, ps in procs.items():
        rcs, out = wait_all(ps, RANK_TIMEOUT_S)
        if any(rcs):
            pytest.fail("\n".join(f"--- world {world} rank {i} (rc={rc}) ---\n{o[-3000:]}"
                                  for i, (rc, o) in enumerate(zip(rcs, out))))
        outs[world] = out
    return d, ckpt, outs


def _files(d):
    return sorted(os.path.relpath(os.path.join(root, f), d) for root, _, fs in os.walk(d) for f in fs)


def _lines(outs, prefix):
    return [line for out in outs for line in out.splitlines() if line.startswith(prefix)]


def test_two_ranks_train_one_hookpoint_each_as_the_tp_trainer(runs):
    d, _, outs = runs
    stops = _lines(outs[2], "STOPPED run=")
    assert [s for s in stops if "run=dm " in s] == [
        "STOPPED run=dm rank=0 global_step=8 hooks=layers.1", "STOPPED run=dm rank=1 global_step=8 hooks=layers.2"]
    assert [s for s in stops if "run=tp " in s] == [
        f"STOPPED run=tp rank={r} global_step=8 hooks=layers.1,layers.2" for r in (0, 1)]
    tp, dm = d / "w2" / "tp", d / "w2" / "dm"
    assert _files(tp) == _files(dm) and "layers.2/sae.safetensors" in _files(dm)
    for name in _files(dm):
        if name != "config.json":
            assert (dm / name).read_bytes() == (tp / name).read_bytes(), name
    configs = [json.loads((r / "config.json").read_text()) for r in (tp, dm)]
    assert [c.pop("distribute_modules") for c in configs] == [False, True]
    assert [c.pop("run_name") for c in configs] == [str(tp), str(dm)] and configs[0] == configs[1]
    state = json.loads((dm / "state.json").read_text())
    assert (state["global_step"], state["opt_step"]) == (8, 4)
    sae = load_file(str(dm / "layers.2" / "sae.safetensors"))
    assert torch.isfinite(sae["W_dec"]).all()


def test_preempted_on_one_rank_and_resumed(runs):
    """Rank 1 alone catches SIGTERM after batch 1; both stop at the
    boundary of batch 2, each having written its hookpoint, and `--resume`
    ends with the uninterrupted run's files."""
    from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
    from multimodal_sae_tpu.config import TrainConfig as JaxTrainConfig
    from multimodal_sae_tpu.models import SyntheticActivationSource as JaxSource
    from multimodal_sae_tpu.parallel import get_mesh
    from multimodal_sae_tpu.train import SaeTrainer as JaxTrainer
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.models import SyntheticActivationSource
    from multimodal_sae_tpu_torch.train import SaeTrainer

    d, _, outs = runs
    assert [s for s in _lines(outs[2], "STOPPED run=resumed")] == [
        "STOPPED run=resumed rank=0 global_step=2 hooks=layers.1",
        "STOPPED run=resumed rank=1 global_step=2 hooks=layers.2"]
    assert _lines(outs[2], "RESUMED") == ["RESUMED rank=0 global_step=8", "RESUMED rank=1 global_step=8"]
    resumed, dm = d / "w2" / "resumed", d / "w2" / "dm"
    for name in _files(dm):
        if name != "config.json":
            assert (resumed / name).read_bytes() == (dm / name).read_bytes(), name
    # A world-1 trainer of either package resumes the two ranks'
    # checkpoint, every hookpoint.
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4), batch_size=2, hookpoints=list(HOOKS),
                      distribute_modules=True, log_to_wandb=False)
    port = SaeTrainer(cfg, [], SyntheticActivationSource(d_model=64, n_layers=3, vocab=256, device="cpu"),
                      device="cpu")
    port.load_state(str(dm))
    jax_trainer = JaxTrainer(JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=4, k=4), batch_size=2,
                                            hookpoints=list(HOOKS), log_to_wandb=False),
                             [], JaxSource(d_model=64, n_layers=3, vocab=256),
                             mesh=get_mesh(("data",), devices=jax.devices()[:1]))
    jax_trainer.load_state(str(dm))
    assert port.module_plan == [HOOKS] and port.global_step == jax_trainer.global_step == 8
    for hook in HOOKS:
        files = Sae.load_from_disk(dm / hook, device="cpu").params
        for name, t in files.items():
            assert torch.equal(port.saes[hook].params[name].detach(), t), (hook, name)
            np.testing.assert_array_equal(np.asarray(jax_trainer.saes[hook].params[name]), t.numpy())


def test_four_ranks_equal_four_ranks_without_the_flag(runs):
    d, _, outs = runs
    stops = _lines(outs[4], "STOPPED run=dm")
    assert stops == [f"STOPPED run=dm rank={r} global_step=4 hooks={HOOKS[r % 2]}" for r in range(4)]
    tp, dm = d / "w4" / "tp", d / "w4" / "dm"
    assert _files(tp) == _files(dm)
    for hook in HOOKS:
        got, want = load_file(str(dm / hook / "sae.safetensors")), load_file(str(tp / hook / "sae.safetensors"))
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL, err_msg=f"{hook} {name}")
    got, want = load_file(str(dm / "state.safetensors")), load_file(str(tp / "state.safetensors"))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy())


class _GridCaptures:
    """The JAX subject with its captures rounded onto the drivers' grid."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def capture(self, batch, hookpoints):
        return {h: jnp.clip(jnp.round(x * 8) / 8, -2, 2) for h, x in self.model.capture(batch, hookpoints).items()}


@pytest.mark.parametrize("world", [2, 4])
def test_against_the_jax_trainer(runs, world):
    """The JAX trainer over the CLI's shuffled rows (seed 42; at world 4
    each step takes both TP groups' rows, group g's step s being rows
    8g + 2s, 8g + 2s + 1), from the port's initial parameters."""
    from datasets import Dataset

    from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
    from multimodal_sae_tpu.config import TrainConfig as JaxTrainConfig
    from multimodal_sae_tpu.models.hf_loader import load_llama as jax_load
    from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlama
    from multimodal_sae_tpu.parallel import get_mesh
    from multimodal_sae_tpu.train import SaeTrainer as JaxTrainer
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.convert import sae_params_from_jax, sae_params_to_jax

    d, ckpt, _ = runs
    shuffled = Dataset.load_from_disk(str(d / "ds")).shuffle(42).with_format("numpy")
    groups = world // 2
    per_group = 16 // groups
    order = [per_group * g + 2 * s + i for s in range(per_group // 2) for g in range(groups) for i in range(2)]
    rows = [{"input_ids": shuffled[j]["input_ids"]} for j in order]
    params, cfg = jax_load(ckpt, dtype=jnp.float32)
    batch_size = 2 * groups
    jt = JaxTrainer(JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=4, k=4), batch_size=batch_size, grad_acc_steps=2,
                                   lr_warmup_steps=1, hookpoints=list(HOOKS), log_to_wandb=False, save_every=10_000),
                    rows, _GridCaptures(JaxLlama(params, cfg)), mesh=get_mesh(("data",), devices=jax.devices()[:1]))
    init_dec = {}
    for i, hook in enumerate(HOOKS):  # the port's initial parameters (seeded by the hookpoint's index)
        init = Sae(64, SaeConfig(expansion_factor=4, k=4), seed=i, device="cpu").params
        init_dec[hook] = init["W_dec"].clone()
        jt.saes[hook].params = {k: jnp.asarray(v) for k, v in sae_params_to_jax(init).items()}
        jt.opt_states[hook] = jt.optimizer.init(jt.saes[hook].params)
    for s in range(len(rows) // batch_size):
        jt.step({"input_ids": np.stack([r["input_ids"] for r in rows[s * batch_size:(s + 1) * batch_size]])})
    assert jt.global_step == len(rows) // batch_size
    for hook in HOOKS:
        got = Sae.load_from_disk(d / f"w{world}" / "dm" / hook, device="cpu").params
        want = sae_params_from_jax({k: np.asarray(v) for k, v in jt.saes[hook].params.items()}, device="cpu")
        assert not torch.equal(want["W_dec"], init_dec[hook])
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), **TOL, err_msg=f"{hook} {name}")


def test_the_plan_names_the_group_it_divides_by():
    widths = {h: 64 for h in ("layers.0", *HOOKS)}
    with pytest.raises(ValueError, match=r"divisible by the group count: 3 hookpoint\(s\) over 2 ranks of a --tp 2"):
        module_plan(["layers.0", *HOOKS], widths, 2, group="ranks of a --tp 2 group")
    with pytest.raises(ValueError, match="over 2 ranks of the world"):
        module_plan(["layers.0", *HOOKS], widths, 2, group="ranks of the world")
    assert module_plan(HOOKS, widths, 2) == [["layers.1"], ["layers.2"]]
