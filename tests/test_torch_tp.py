"""Tensor parallelism on process groups (`--tp`, parallel/tensor_parallel.py)
on the CPU over gloo, on the tiny LLaMA of tests/torch_tp_tiny.py (8 query
and 4 KV heads, so each of two ranks runs 4 and 2).

* The split: every weight's split dimension is the JAX package's, read in
  the port's (out, in) layout, and an int8 leaf's slices are the rank's
  shard of the JAX package's placement of one whole quantisation.
* Two ranks at `--tp 2` in fp32 (tests/torch_mp_drivers/mp_tp.py): the
  captures and logits of a right-padded batch within FORWARD_TOL of the
  port's unsharded run, of the JAX subject and of the JAX subject on its
  TP mesh of 2 virtual devices; the gradient of a logit metric at the
  embeddings (through both autograd operators and the head's gather) and
  fast attribution's saliency within GRAD_TOL of the unsharded run's; the
  greedy tokens equal; every output equal bit for bit on both ranks; the
  collectives counted where they belong.
* The tiny LLaVA-NeXT (tests/torch_llava_tiny.py: 4 query and 2 KV heads)
  at `--tp 2`, its tower replicated: two image rows' captures and logits
  within FORWARD_TOL of the unsharded run, the greedy tokens equal, fast
  attribution within the saliency tolerance.
* A world of 4 (two TP groups of 2) runs the cache CLI and the training CLI
  at `--tp 2`: the cache equals byte for byte the world-2 run's and a
  one-process unsharded run's (captures on the drivers' grid with the grid
  SAE, so the encoder is exact), and the trained SAE is the one-process
  trainer's on the groups' interleaved batches within TRAIN_TOL.
* The refusals: a `--tp` that does not divide the KV heads, a world that
  `--tp` does not divide, `--tp` with `--dp`, and either on a synthetic
  subject.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_mp import start_ranks, wait_all
from torch_mp_drivers.common import on_grid
from torch_tp_tiny import EOS, TP_TINY, write_checkpoint, write_grid_sae

FORWARD_TOL = dict(rtol=1e-5, atol=2e-5)  # fp32 with the row-split sums in another order
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)  # gradients up to about 30
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)  # JAX test_multiprocess.py:211-214
HOOKS = [f"layers.{i}" for i in range(TP_TINY["num_hidden_layers"])]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("tp_llama"))


# ---- the split ---------------------------------------------------------------------


def test_split_dims_are_the_jax_specs():
    from multimodal_sae_tpu.parallel import llama_param_specs as jax_specs
    from multimodal_sae_tpu_torch.parallel import llama_param_specs

    ours = llama_param_specs()
    for name, spec in jax_specs().items():  # (in, out) -> (out, in): JAX's dim d is ours 1 - d
        want = None if all(s is None for s in spec) else 1 - [s is not None for s in spec].index(True)
        assert ours[name] == want, name
    assert {k: ours[k] for k in ("embed_tokens", "norm", "lm_head")} == {"embed_tokens": None, "norm": None,
                                                                         "lm_head": 0}


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_leaves_split_like_the_jax_placement(ckpt, tp):
    """Each rank's q8 and scale are its shard of the JAX package's TP
    placement of the same quantised tree (JAX tensor_parallel.py:55-66): a
    row split cuts the scale with the rows, a column split keeps it whole."""
    from multimodal_sae_tpu.models.hf_loader import load_llama as jax_load
    from multimodal_sae_tpu.models.quant import quantize_llama_params as jax_quantize
    from multimodal_sae_tpu.parallel import get_mesh
    from multimodal_sae_tpu.parallel import shard_llama_params as jax_shard
    from multimodal_sae_tpu_torch.models.hf_loader import load_llama
    from multimodal_sae_tpu_torch.models.quant import quantize_llama_params
    from multimodal_sae_tpu_torch.parallel import shard_llama_params

    params, _ = load_llama(ckpt, dtype=torch.float32, device="cpu")
    whole = quantize_llama_params(params, device="cpu")
    jparams, _ = jax_load(ckpt, dtype=jnp.float32)
    placed = jax_shard(jax_quantize(jparams), get_mesh(("model",), devices=jax.devices()[:tp]))

    def shard(arr, r):  # device r's block of a placed JAX array
        (s,) = [s for s in arr.addressable_shards if s.device == jax.devices()[r]]
        return np.asarray(s.data)

    for r in range(tp):
        ours = shard_llama_params(whole, tp, r)
        pairs = [(ours["layers"][1][name], placed["layers"][1][name], name)
                 for name in ("q_proj", "k_proj", "o_proj", "gate_proj", "down_proj")]
        for got, want, name in pairs + [(ours["lm_head"], placed["lm_head"], "lm_head")]:
            np.testing.assert_array_equal(got["q8"].numpy().T, shard(want["q8"], r), err_msg=name)
            np.testing.assert_array_equal(got["scale"].numpy(), shard(want["scale"], r), err_msg=name)
        assert ours["embed_tokens"] is whole["embed_tokens"]


# ---- two ranks against the unsharded subject and JAX ------------------------------


def _wait(procs, timeout=300):
    rcs, outs = wait_all(procs, timeout)
    if any(rcs):
        pytest.fail("\n".join(f"--- process {i} (rc={rc}) ---\n{o[-3000:]}" for i, (rc, o) in enumerate(zip(rcs, outs))))


@pytest.fixture(scope="module")
def rank_runs(ckpt, tmp_path_factory):
    """mp_tp.py's forward (the tiny LLaMA) and llava (the tiny LLaVA-NeXT)
    modes at --tp 2 (two ranks each) and unsharded (world 1), six processes
    at once; returns {mode: (rank 0, rank 1, solo)} and the forward's
    inputs."""
    from torch_llava_tiny import write_checkpoint as write_llava

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.sae import Sae

    d = tmp_path_factory.mktemp("tp_ranks")
    Sae(64, SaeConfig(num_latents=128, k=8), seed=3, device="cpu").save_to_disk(d / "saes" / "layers.1")
    Sae(64, SaeConfig(num_latents=64, k=4), seed=3, device="cpu").save_to_disk(d / "saes" / "model.layers.1")
    (d / "llava").mkdir()
    llava_ckpt = write_llava(d / "llava")
    rng = np.random.default_rng(0)
    mask = np.ones((3, 10), np.int64)
    mask[1, 7:] = mask[2, 5:] = 0
    gen_mask = np.ones((2, 6), np.int64)
    gen_mask[1, :2] = 0
    inputs = dict(ids=rng.integers(1, 255, size=(3, 10)), mask=mask,
                  weights=rng.standard_normal((3, 10, 256)).astype(np.float32),
                  gen_ids=rng.integers(1, 255, size=(2, 6)), gen_mask=gen_mask,
                  attr_ids=rng.integers(1, 255, size=(2, 7)), answers=np.array([[3, 7], [11, 5]]),
                  feats=np.array([0, 5, 9, 17, 40, 77, 100]))
    np.savez(d / "inputs.npz", **inputs)
    procs = []
    for mode, args in (("forward", [ckpt, d / "inputs.npz", d / "saes"]), ("llava", [llava_ckpt, d / "saes"])):
        procs += start_ranks("mp_tp.py", [mode, *args, d / f"{mode}_tp"], solo_args=[mode, *args, d / f"{mode}_solo"])
    _wait(procs)
    runs = {mode: tuple(dict(np.load(d / name)) for name in (f"{mode}_tp.rank0.npz", f"{mode}_tp.rank1.npz",
                                                              f"{mode}_solo.rank0.npz"))
            for mode in ("forward", "llava")}
    return runs, inputs


@pytest.fixture(scope="module")
def forward_runs(rank_runs):
    """The tiny LLaMA's (rank 0, rank 1, solo, the inputs)."""
    runs, inputs = rank_runs
    return runs["forward"] + (inputs,)


def test_ranks_hold_the_same_bits(forward_runs):
    r0, r1, _, _ = forward_runs
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)


def test_forward_matches_the_unsharded_port_and_jax(ckpt, forward_runs):
    from multimodal_sae_tpu.models.hf_loader import load_llama as jax_load
    from multimodal_sae_tpu.models.llama import LlamaModel as JaxLlama
    from multimodal_sae_tpu.parallel import shard_subject_model as jax_shard_subject

    tp, _, solo, inputs = forward_runs
    batch = {"input_ids": inputs["ids"], "attention_mask": inputs["mask"]}
    params, cfg = jax_load(ckpt, dtype=jnp.float32)
    jax_ref = JaxLlama(params, cfg).forward(batch, capture=HOOKS)
    jax_tp_model, mesh = jax_shard_subject(JaxLlama(params, cfg), 2)
    assert mesh.devices.size == 2
    jax_tp = jax_tp_model.forward(batch, capture=HOOKS)
    valid = inputs["mask"].astype(bool)  # the attended positions
    for name in HOOKS + ["logits"]:
        got = tp[name]
        refs = {"port": solo[name]}
        for label, out in (("jax", jax_ref), ("jax_tp", jax_tp)):
            refs[label] = np.asarray(out["logits"] if name == "logits" else out["captured"][name])
        for label, want in refs.items():
            np.testing.assert_allclose(got[valid], want[valid], **FORWARD_TOL, err_msg=f"{name} vs {label}")


def test_backward_through_the_collectives_matches_the_unsharded_port(forward_runs):
    tp, _, solo, _ = forward_runs
    assert np.abs(solo["dx"]).max() > 1
    np.testing.assert_allclose(tp["dx"], solo["dx"], **GRAD_TOL)
    assert tp["sal"].shape == (7, 2, 7) and np.abs(solo["sal"]).max() > 0.01
    np.testing.assert_allclose(tp["sal"], solo["sal"], rtol=1e-5, atol=1e-6)


def test_generate_and_the_collectives_counted(forward_runs):
    tp, _, solo, _ = forward_runs
    np.testing.assert_array_equal(tp["gen"], solo["gen"])
    assert EOS not in tp["gen"][:, 6:]  # all 8 steps ran
    # All-reduces: 2 a layer (3 layers) a forward; forwards: the batch (6),
    # the gradient's (6, and its backward 2 a layer + the head's input: 7),
    # 8 generate steps (48), attribution's prefix to layers.1 (4) and 3
    # chunks of the suffix (layer 2: 2, its backward 3).  Gathers: one a
    # head projection (1 + 1 + 8 + 3).
    assert tp["counts"].tolist() == [6 + 13 + 48 + 4 + 3 * 5, 1 + 1 + 8 + 3]
    assert solo["counts"].tolist() == [0, 0]


def test_llava_at_tp2_matches_the_unsharded_run(rank_runs):
    r0, r1, solo = rank_runs[0]["llava"]
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    for name in ("hidden", "logits"):
        np.testing.assert_allclose(r0[name], solo[name], **FORWARD_TOL, err_msg=name)
    np.testing.assert_array_equal(r0["gen"], solo["gen"])
    assert np.abs(solo["sal"]).max() > 1e-3
    np.testing.assert_allclose(r0["sal"], solo["sal"], rtol=1e-5, atol=1e-6)


# ---- the CLIs in a world of 4 ------------------------------------------------------

TRAIN_FLAGS = ["--hookpoints", "layers.1", "--batch_size", "2", "--grad_acc_steps", "2", "--lr_warmup_steps", "2",
               "--expansion_factor", "4", "--k", "4", "--ctx_len", "8", "--no_log_to_wandb", "--save_every", "10000"]


@pytest.fixture(scope="module")
def cli_runs(ckpt, tmp_path_factory):
    """The cache (and training) CLIs at --tp 2 in a world of 4 and the
    cache at world 2, all six processes at once."""
    from datasets import Dataset

    d = tmp_path_factory.mktemp("tp_cli")
    ids = np.random.default_rng(3).integers(1, 255, size=(16, 8))
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(d / "ds"))
    write_grid_sae(d / "saes", "layers.1", 64)
    base = ["cache", ckpt, d / "ds", d / "saes"]
    procs = start_ranks("mp_tp.py", [*base, d / "cache4", d / "run4", *TRAIN_FLAGS], world=4)
    procs += start_ranks("mp_tp.py", [*base, d / "cache2"], world=2)
    _wait(procs)
    return d


@pytest.fixture
def grid_captures(monkeypatch):
    """One-process runs with the drivers' grid captures, in fp32."""
    from multimodal_sae_tpu_torch.launch import utils as launch_utils
    from multimodal_sae_tpu_torch.models.llama import LlamaModel
    from torch_mp_drivers.common import in_fp32

    capture = LlamaModel.capture
    monkeypatch.setattr(LlamaModel, "capture",
                        lambda self, batch, hooks: {h: on_grid(x) for h, x in capture(self, batch, hooks).items()})
    monkeypatch.setattr(launch_utils, "load_subject_model", in_fp32(launch_utils.load_subject_model))


def _files(d):
    files = sorted(os.listdir(d))
    assert files and not any(f.startswith("Rank") for f in files), files
    return {f: (d / f).read_bytes() for f in files}


def test_cache_of_two_tp_groups_equals_one_group_and_one_process(ckpt, cli_runs, grid_captures):
    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch.cache import cache as cache_cli
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    d = cli_runs
    cache_cli.main(CacheConfig(model=ckpt, dataset=str(d / "ds"), sae_path=str(d / "saes"), save_dir=str(d / "solo"),
                               batch_size=2, ctx_len=8, n_splits=2), device="cpu")
    four, two, solo = (_files(d / name / "layers.1") for name in ("cache4", "cache2", "solo"))
    assert len(four) == 4 and four == two == solo
    rows = np.concatenate([load_file(str(d / "cache4" / "layers.1" / f))["locations"].numpy()[:, 0]
                           for f in four if f.endswith(".safetensors")])
    assert set(rows.tolist()) == set(range(16))


def test_training_of_two_tp_groups_matches_one_trainer(ckpt, cli_runs, grid_captures):
    """The training CLI's shuffle (seed 42) and its shards over the 2 TP
    groups: group g's step s is rows 8g + 2s, 8g + 2s + 1 of the shuffled
    set; the one-process trainer takes both groups' rows each step."""
    from datasets import Dataset

    from multimodal_sae_tpu_torch.config import TrainConfig, SaeConfig
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.sae import Sae
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    d = cli_runs
    shuffled = Dataset.load_from_disk(str(d / "ds")).shuffle(42).with_format("numpy")
    order = [8 * g + 2 * s + i for s in range(4) for g in range(2) for i in range(2)]
    model, _, _ = load_subject_model(ckpt, device="cpu")
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4), batch_size=4, grad_acc_steps=2, lr_warmup_steps=2,
                      hookpoints=["layers.1"], run_name=str(d / "solo_run"), log_to_wandb=False, save_every=10_000)
    oracle = SaeTrainer(cfg, shuffled.select(order), model, device="cpu")
    oracle.fit()
    got = Sae.load_from_disk(d / "run4" / "layers.1", device="cpu").params
    for name, want in oracle.saes["layers.1"].params.items():
        np.testing.assert_allclose(got[name].numpy(), want.detach().numpy(), **TRAIN_TOL, err_msg=name)
    state = json.loads((d / "run4" / "state.json").read_text())
    assert state["opt_step"] == oracle.opt_step == 2 and state["global_step"] == oracle.global_step == 4
    counts = load_file(str(d / "run4" / "state.safetensors"))["num_tokens_since_fired/layers.1"].numpy()
    np.testing.assert_array_equal(counts * 2, oracle.num_tokens_since_fired["layers.1"])


# ---- refusals ----------------------------------------------------------------------


def test_refuses_a_tp_that_does_not_divide_the_kv_heads():
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.parallel import shard_subject_model

    cfg = LlamaConfig(**{k: v for k, v in TP_TINY.items() if k != "max_position_embeddings"})
    with pytest.raises(ValueError, match="num_key_value_heads"):
        shard_subject_model(LlamaModel.random(cfg, dtype=torch.float32, device="cpu"), 8)


def test_refuses_a_world_that_tp_does_not_divide():
    from multimodal_sae_tpu_torch.parallel.tensor_parallel import tensor_parallel_layout

    with pytest.raises(ValueError, match="world size it divides"):
        tensor_parallel_layout(2)  # no process group: a world of 1


def test_refuses_tp_with_dp(ckpt):
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model

    with pytest.raises(ValueError, match="mutually exclusive"):
        load_subject_model(ckpt, device="cpu", tp=2, dp=2)


@pytest.mark.parametrize("flag", ["tp", "dp"])
def test_refuses_tp_or_dp_on_a_synthetic_subject(flag):
    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch.utils import load_subject_or_synthetic

    with pytest.raises(ValueError, match="synthetic"):
        load_subject_or_synthetic(CacheConfig(model="synthetic://16,2,64", **{flag: 2}), device="cpu")
