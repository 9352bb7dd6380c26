"""Rank driver of the tensor-parallel tests (tests/test_torch_tp.py): the
tiny LLaMA of tests/torch_tp_tiny.py loaded through `load_subject_model`
in fp32 with `--tp` = the world (no `--tp` as the world-1 run).

    forward <ckpt> <inputs.npz> <sae_dir> <out_prefix>
        captures, logits, the gradient of a logit metric at the input
        embeddings, a greedy generate and fast attribution maps, written to
        {out_prefix}.rank{r}.npz with the collectives' counts.
    llava <ckpt> <sae_dir> <out_prefix>
        the tiny LLaVA-NeXT of tests/torch_llava_tiny.py (its language model
        sharded, the tower replicated): captures and logits of two image
        rows, a greedy generate and fast attribution maps.
    remat <ckpt> <inputs.npz> <sae_dir> <out_prefix>
        forward's gradient at the embeddings and fast attribution maps on
        the subject loaded without and with `remat`, each with the
        collectives' counts, written to {out_prefix}.rank{r}.npz.
    cache <ckpt> <dataset_dir> <sae_dir> <save_dir> [<run_dir> TRAIN FLAGS...]
        the cache CLI at --tp 2 (captures rounded onto the grid), then with
        a run directory the training CLI at --tp 2 on the same subject.
    train <ckpt> <dataset_dir> <out_dir> <runs> TRAIN FLAGS...
        the training CLI at --tp 2 (grid captures, fp32) once for each of
        the comma-separated `runs`, into {out_dir}/{run}: "tp" as it is,
        "dm" with --distribute_modules, "resumed" with --distribute_modules
        where rank 1 sends itself SIGTERM after its first batch and the run
        is resumed (--resume) to its end; each stop printed."""

import sys
from functools import partial

import common

import numpy as np
import torch


def forward(ckpt, inputs, sae_dir, out_prefix):
    rank = common.start()
    import os

    from multimodal_sae_tpu_torch.features.patching.attribution import fast_attribution_maps
    from multimodal_sae_tpu_torch.features.patching.utils import get_logit_diff
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.models.llama import llama_forward
    from multimodal_sae_tpu_torch.parallel import tensor_parallel
    from multimodal_sae_tpu_torch.sae import Sae

    world = int(os.environ.get("WORLD_SIZE", 1))
    model, _, _ = load_subject_model(ckpt, dtype=torch.float32, device="cpu", tp=world if world > 1 else 0)
    inp = np.load(inputs)
    hooks = [f"layers.{i}" for i in range(model.cfg.num_hidden_layers)]
    out = model.forward({"input_ids": inp["ids"], "attention_mask": inp["mask"]}, capture=hooks)
    # The gradient at the embeddings of a metric of the whole vocabulary's
    # logits: it crosses every layer's two collectives and the head's gather.
    x = model.params["embed_tokens"][torch.as_tensor(inp["ids"])].clone().requires_grad_(True)
    logits = llama_forward(model.params, model.cfg, inputs_embeds=x, attention_mask=torch.as_tensor(inp["mask"]))
    (logits["logits"] * torch.as_tensor(inp["weights"])).sum().backward()
    gen = model.generate({"input_ids": inp["gen_ids"], "attention_mask": inp["gen_mask"]}, max_new_tokens=8)
    sae = Sae.load_from_disk(os.path.join(sae_dir, "layers.1"), device="cpu")
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(inp["answers"]))
    maps = fast_attribution_maps(model, "layers.1", sae, {"input_ids": inp["attr_ids"]}, metric, inp["feats"],
                                 feature_batch=3, progress=False)
    np.savez(f"{out_prefix}.rank{rank}.npz", logits=out["logits"].detach().numpy(), dx=x.grad.numpy(),
             gen=gen.numpy(), sal=np.stack(maps["layers.1"]),
             counts=np.array([tensor_parallel.collective_counts[k] for k in ("all_reduce", "all_gather")]),
             **{h: out["captured"][h].detach().numpy() for h in hooks})


def remat(ckpt, inputs, sae_dir, out_prefix):
    rank = common.start()
    import os

    from multimodal_sae_tpu_torch.features.patching.attribution import fast_attribution_maps
    from multimodal_sae_tpu_torch.features.patching.utils import get_logit_diff
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.models.llama import llama_forward
    from multimodal_sae_tpu_torch.parallel import tensor_parallel
    from multimodal_sae_tpu_torch.sae import Sae

    world = int(os.environ.get("WORLD_SIZE", 1))
    inp = np.load(inputs)
    sae = Sae.load_from_disk(os.path.join(sae_dir, "layers.1"), device="cpu")
    metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(inp["answers"]))
    out = {}
    for tag, flag in (("plain", False), ("remat", True)):
        model, _, _ = load_subject_model(ckpt, dtype=torch.float32, device="cpu", tp=world if world > 1 else 0,
                                         remat=flag)
        assert model.cfg.remat is flag
        for key in tensor_parallel.collective_counts:
            tensor_parallel.collective_counts[key] = 0
        x = model.params["embed_tokens"][torch.as_tensor(inp["ids"])].clone().requires_grad_(True)
        logits = llama_forward(model.params, model.cfg, inputs_embeds=x, attention_mask=torch.as_tensor(inp["mask"]))
        (logits["logits"] * torch.as_tensor(inp["weights"])).sum().backward()
        maps = fast_attribution_maps(model, "layers.1", sae, {"input_ids": inp["attr_ids"]}, metric, inp["feats"],
                                     feature_batch=3, progress=False)
        out.update({f"{tag}_dx": x.grad.numpy(), f"{tag}_sal": np.stack(maps["layers.1"]),
                    f"{tag}_counts": np.array([tensor_parallel.collective_counts[k]
                                               for k in ("all_reduce", "all_gather")])})
    np.savez(f"{out_prefix}.rank{rank}.npz", **out)


def llava(ckpt, sae_dir, out_prefix):
    rank = common.start()
    import os

    from torch_llava_tiny import IMG_TOKEN, images

    from multimodal_sae_tpu_torch.features.patching.attribution import fast_attribution_maps
    from multimodal_sae_tpu_torch.features.patching.utils import get_logit_diff
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.sae import Sae

    world = int(os.environ.get("WORLD_SIZE", 1))
    model, _, _ = load_subject_model(ckpt, dtype=torch.float32, device="cpu", tp=world if world > 1 else 0)
    hook = "model.layers.1"
    batch = model.prepare_inputs(images=images([(50, 70), (90, 40)], seed=3),
                                 prompt_ids=[[5, IMG_TOKEN, 6, 7], [9, IMG_TOKEN, 4]])
    out = model.forward(batch, capture=[hook])
    gen = model.generate(batch, max_new_tokens=6)
    sae = Sae.load_from_disk(os.path.join(sae_dir, hook), device="cpu")
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[3, 7], [11, 5]]))
    maps = fast_attribution_maps(model, hook, sae, batch, metric, np.array([0, 3, 9, 20, 33]), feature_batch=2,
                                 progress=False)
    np.savez(f"{out_prefix}.rank{rank}.npz", hidden=out["captured"][hook].detach().numpy(),
             logits=out["logits"].detach().numpy(), gen=gen.numpy(), sal=np.stack(maps[hook]))


def _grid_fp32():
    """Load the subject in fp32 and round its captures onto the grid."""
    from multimodal_sae_tpu_torch.launch import utils as launch_utils
    from multimodal_sae_tpu_torch.models.llama import LlamaModel

    launch_utils.load_subject_model = common.in_fp32(launch_utils.load_subject_model)
    capture = LlamaModel.capture
    LlamaModel.capture = lambda self, batch, hooks: {h: common.on_grid(x) for h, x in capture(self, batch, hooks).items()}


def flows(ckpt, dataset_dir, sae_dir, save_dir, run_dir=None, *train_flags):
    common.start()
    from multimodal_sae_tpu_torch import __main__ as train_cli
    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch.cache import cache as cache_cli

    _grid_fp32()
    cache_cli.main(CacheConfig(model=ckpt, dataset=dataset_dir, sae_path=sae_dir, save_dir=save_dir, batch_size=2,
                               ctx_len=8, n_splits=2, tp=2), device="cpu")
    if run_dir is not None:
        train_cli.run([ckpt, dataset_dir, "--tp", "2", "--run_name", run_dir, *train_flags], device="cpu")


def train(ckpt, dataset_dir, out_dir, runs, *train_flags):
    rank = common.start()
    import os
    import signal

    from multimodal_sae_tpu_torch import __main__ as train_cli
    from multimodal_sae_tpu_torch.train import SaeTrainer

    _grid_fp32()
    step, preempt = SaeTrainer.step, []

    def step_then_signal(self, *args, **kw):
        step(self, *args, **kw)
        if preempt and rank == 1 and self.global_step == 1:
            preempt.clear()
            os.kill(os.getpid(), signal.SIGTERM)

    SaeTrainer.step = step_then_signal
    for run in runs.split(","):
        args = [ckpt, dataset_dir, "--tp", "2", "--run_name", os.path.join(out_dir, run), *train_flags]
        args += [] if run == "tp" else ["--distribute_modules"]
        preempt[:] = [True] if run == "resumed" else []
        trainer = train_cli.run(args, device="cpu")
        print(f"STOPPED run={run} rank={rank} global_step={trainer.global_step} hooks={','.join(trainer.saes)}",
              flush=True)
        if run == "resumed":
            trainer = train_cli.run(args + ["--resume"], device="cpu")
            print(f"RESUMED rank={rank} global_step={trainer.global_step}", flush=True)


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    {"forward": forward, "remat": remat, "llava": llava, "cache": flows, "train": train}[mode](*args)
