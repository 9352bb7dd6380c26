"""Module-sharded SAE training (`TrainConfig.distribute_modules`,
train/module_sharded.py) against the JAX package.

* World 1: `SaeTrainer` trains every hookpoint in one process.  Held
  against the oracle of JAX tests/test_module_sharded.py:42, the JAX SAE
  update run on each hookpoint alone, from the same weights
  (`convert.sae_params_from_jax`) and with the JAX trainer's geometric
  median b_dec and warm-up schedule: fvu within rtol 2e-4, the parameters
  within rtol 3e-4 (that test's tolerances).
* Two gloo ranks, two hookpoints, one a rank (tests/torch_mp_drivers/
  mp_modules.py): each rank's SAE, optimizer state and files equal the
  world-1 port run on the same global batches within fp32 noise (rtol
  1e-5, atol 1e-6), the checkpoint's file layout is the same, and the
  dead-feature counters are the world-1 run's halved (each rank counts its
  own `input_ids`, JAX trainer.py:556, while its fired masks cover the
  global batch).  Each rank resumes from the checkpoint bit for bit; so do
  a world-1 port trainer and the JAX trainer.
* An uneven split and unequal widths raise with the JAX package's messages.
"""

import json
import os
from collections import defaultdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.config import TrainConfig as JaxTrainConfig
from multimodal_sae_tpu.models import SyntheticActivationSource as JaxSource
from multimodal_sae_tpu.ops import geometric_median as jax_geometric_median
from multimodal_sae_tpu.parallel import get_mesh
from multimodal_sae_tpu.sae import (
    forward as jax_forward,
    init_params,
    remove_gradient_parallel_to_decoder_directions,
    set_decoder_norm_to_unit_norm,
)
from multimodal_sae_tpu.train import SaeTrainer as JaxTrainer
from multimodal_sae_tpu.train.trainer import linear_warmup_schedule
from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.models import SyntheticActivationSource
from multimodal_sae_tpu_torch.sae import Sae
from multimodal_sae_tpu_torch.train import SaeTrainer
from multimodal_sae_tpu_torch.train.module_sharded import module_plan
from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

from torch_mp import run_ranks

M, D, N, STEPS = 4, 32, 64, 3
LR = 1e-3
HOOKS = [f"layers.{m}" for m in range(M)]


class StackedSource:
    """A subject whose hookpoint layers.m gives `hiddens[m]` (N, d) for any
    batch, at the widths given."""

    def __init__(self, hiddens, widths=None):
        self.hiddens = hiddens
        self.widths = widths or {h: D for h in HOOKS}

    def hookpoint_names(self):
        return list(self.widths)

    def layers_name(self):
        return "layers"

    def resolve_widths(self, hookpoints):
        return {h: self.widths[h] for h in hookpoints}

    def capture(self, batch, hookpoints):
        return {h: self.hiddens[int(h.split(".")[1])] for h in hookpoints}


def _reference_update(params, opt, optimizer, cfg, h, lr):
    """JAX tests/test_module_sharded.py:25-39, with the step's learning rate."""
    params = set_decoder_norm_to_unit_norm(params)

    def loss_fn(p):
        out = jax_forward(p, h, cfg, None)
        return out.fvu + out.multi_topk_fvu / 8, out

    (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    gnorm = jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads)))
    scale = jnp.minimum(1.0, 1.0 / (gnorm + 1e-6))
    grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    grads = remove_gradient_parallel_to_decoder_directions(params, grads)
    updates, opt = optimizer.update(grads, opt, params)
    updates = jax.tree_util.tree_map(lambda u: -lr * u, updates)
    return optax.apply_updates(params, updates), opt, out.fvu


def test_world1_matches_independent_jax_updates():
    cfg = JaxSaeConfig(expansion_factor=4, k=4)
    hiddens = np.random.default_rng(0).normal(size=(M, N, D)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), M)
    optimizer = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    ref_params = [init_params(k, D, cfg) for k in keys]
    ref_opts = [optimizer.init(p) for p in ref_params]

    trainer = SaeTrainer(
        TrainConfig(sae=SaeConfig(expansion_factor=4, k=4), batch_size=1, grad_acc_steps=1, lr=LR,
                    lr_warmup_steps=0, hookpoints=list(HOOKS), distribute_modules=True, log_to_wandb=False,
                    save_every=10**6),
        [{"input_ids": np.zeros(N, np.int64)}] * STEPS, StackedSource(torch.from_numpy(hiddens)), device="cpu")
    assert trainer.module_plan == [HOOKS] and list(trainer.saes) == HOOKS
    with torch.no_grad():
        for m, hook in enumerate(HOOKS):
            for name, t in sae_params_from_jax(ref_params[m], "cpu").items():
                trainer.saes[hook].params[name].copy_(t)
    # The JAX trainer's b_dec start and schedule (its `lr` scaled per step).
    for m in range(M):
        ref_params[m] = dict(ref_params[m], b_dec=jax_geometric_median(jnp.asarray(hiddens[m])))
    schedule = linear_warmup_schedule(0, STEPS)

    for step in range(STEPS):
        metrics = {hook: defaultdict(float) for hook in HOOKS}
        trainer.step({"input_ids": np.zeros((1, N), np.int64)}, avg_metrics=metrics)
        ref_fvus = []
        for m in range(M):
            ref_params[m], ref_opts[m], fvu = _reference_update(
                ref_params[m], ref_opts[m], optimizer, cfg, jnp.asarray(hiddens[m]), LR * schedule(step))
            ref_fvus.append(float(fvu))
        np.testing.assert_allclose([metrics[h]["fvu"] for h in HOOKS], ref_fvus, rtol=2e-4, atol=1e-6)
    assert trainer.opt_step == STEPS
    for m, hook in enumerate(HOOKS):
        for name, t in trainer.saes[hook].params.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(ref_params[m][name]), rtol=3e-4, atol=3e-6,
                                       err_msg=f"{hook} {name}")


def _files(d):
    return sorted(os.path.relpath(os.path.join(root, f), d) for root, _, fs in os.walk(d) for f in fs)


TOL = dict(rtol=1e-5, atol=1e-6)
LAYOUT = ["config.json", "layers.0/cfg.json", "layers.0/sae.safetensors", "layers.1/cfg.json",
          "layers.1/sae.safetensors", "optimizer_layers_0.safetensors", "optimizer_layers_1.safetensors",
          "state.json", "state.safetensors"]


@pytest.mark.parametrize("variant", ["fvu", "auxk_multi_topk"])
def test_two_ranks_equal_the_world1_run(tmp_path, variant):
    extra = ["auxk"] if variant != "fvu" else []
    ranks, solo = tmp_path / "ranks", tmp_path / "solo"
    run_ranks("mp_modules.py", [ranks, *extra], solo_args=[solo, *extra])
    assert _files(ranks) == _files(solo) == LAYOUT
    for hook in ("layers.0", "layers.1"):
        got = load_file(str(ranks / hook / "sae.safetensors"))
        want = load_file(str(solo / hook / "sae.safetensors"))
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL, err_msg=f"{hook} {name}")
        assert (ranks / hook / "cfg.json").read_bytes() == (solo / hook / "cfg.json").read_bytes()
        opt = f"optimizer_{hook.replace('.', '_')}.safetensors"
        got, want = load_file(str(ranks / opt)), load_file(str(solo / opt))
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL, err_msg=f"{opt} {name}")
    assert (ranks / "state.json").read_bytes() == (solo / "state.json").read_bytes()
    configs = [json.loads((d / "config.json").read_text()) for d in (ranks, solo)]
    assert configs[0].pop("run_name") == str(ranks) and configs[1].pop("run_name") == str(solo)
    assert configs[0].pop("batch_size") == 2 and configs[1].pop("batch_size") == 4
    assert configs[0] == configs[1] and configs[0]["distribute_modules"] is True
    got, want = load_file(str(ranks / "state.safetensors")), load_file(str(solo / "state.safetensors"))
    assert list(got) == list(want) == ["num_tokens_since_fired/layers.0", "num_tokens_since_fired/layers.1"]
    for key in want:
        np.testing.assert_array_equal(got[key].numpy() * 2, want[key].numpy())
    if variant == "fvu":  # AuxK at threshold 0 revives every latent
        assert any((want[key].numpy() > 0).any() and (want[key].numpy() == 0).any() for key in want)

    # Resume at world 1, from the two ranks' checkpoint: the port's trainer
    # and the JAX trainer.
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4, multi_topk=bool(extra)), batch_size=4,
                      hookpoints=["layers.0", "layers.1"], distribute_modules=True, log_to_wandb=False)
    port = SaeTrainer(cfg, [], SyntheticActivationSource(d_model=16, n_layers=2, vocab=64, device="cpu"), device="cpu")
    port.load_state(str(ranks))
    jax_trainer = JaxTrainer(
        JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=4, k=4, multi_topk=bool(extra)), batch_size=4,
                       hookpoints=["layers.0", "layers.1"], log_to_wandb=False),
        [], JaxSource(d_model=16, n_layers=2, vocab=64), mesh=get_mesh(("data",), devices=jax.devices()[:1]))
    jax_trainer.load_state(str(ranks))
    assert port.global_step == jax_trainer.global_step == 4
    for hook in ("layers.0", "layers.1"):
        files = Sae.load_from_disk(ranks / hook, device="cpu").params
        for name, t in files.items():
            assert torch.equal(port.saes[hook].params[name].detach(), t)
            np.testing.assert_array_equal(np.asarray(jax_trainer.saes[hook].params[name]), t.numpy())
        np.testing.assert_array_equal(port.num_tokens_since_fired[hook], got[f"num_tokens_since_fired/{hook}"])


def test_uneven_split_raises_as_jax_does():
    message = "Number of modules must be divisible by the group count"
    with pytest.raises(ValueError, match=message):
        module_plan(["layers.0", "layers.1", "layers.2"], {f"layers.{i}": 16 for i in range(3)}, 2)
    assert module_plan(HOOKS, {h: D for h in HOOKS}, 2) == [HOOKS[:2], HOOKS[2:]]
    # The JAX trainer: ten hookpoints over its eight devices.
    assert jax.device_count() == 8
    with pytest.raises(AssertionError, match=message):
        JaxTrainer(JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=2, k=2), hookpoints=["layers.*"],
                                  distribute_modules=True, log_to_wandb=False),
                   [], JaxSource(d_model=8, n_layers=10, vocab=16))


def test_unequal_widths_raise_as_jax_does():
    widths = {"layers.0": 8, "layers.1": 16}
    with pytest.raises(ValueError) as port_error:
        SaeTrainer(TrainConfig(sae=SaeConfig(expansion_factor=2, k=2), hookpoints=list(widths),
                               distribute_modules=True, log_to_wandb=False),
                   [], StackedSource(None, widths), device="cpu")
    with pytest.raises(ValueError) as jax_error:
        JaxTrainer(JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=2, k=2), hookpoints=list(widths),
                                  distribute_modules=True, log_to_wandb=False),
                   [], StackedSource(None, widths), mesh=get_mesh(("data",), devices=jax.devices()[:2]))
    assert str(port_error.value) == str(jax_error.value)
    assert "All modules must output tensors of the same shape" in str(port_error.value)
