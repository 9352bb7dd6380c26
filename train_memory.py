#!/usr/bin/env python3
"""Peak device memory of the PyTorch port's SAE trainer at full width, for
each `micro_acc_steps`, with and without AuxK; and K2's dvals mode on random
rows.  Needs one CUDA card:

    python3 train_memory.py

The trainer runs at the README's training command's shape: the 25-layer
random LLaMA-3-8B-width subject (bf16, flash attention, hookpoint
layers.24), a 131,072-latent k = 256 fp32 SAE, batches of 8 x 2,048 tokens,
grad_acc_steps 4, lr_warmup_steps 0.  Each setting gets a fresh trainer and
two batches (b_dec's init, then a second with the first's gradient held);
AuxK settings make half the latents dead.  A setting that runs out of
device memory is reported as such, which is what this script is for:
chip_smoke.py takes the least `micro_acc_steps` that fits.  Then K2's dvals
mode at 4,096 tokens x 256 random rows of a random 131,072 x 4,096 fp32
decoder (rows named about 8 times each, beyond what the L2 cache holds):
against its plain version, twice for equal bits, timed.  One JSON line per
measurement; the card's name and power limit first.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

SETTINGS = ((2, False), (1, False), (2, True), (1, True), (4, True))  # (micro_acc_steps, AuxK)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_memory: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.features.cache import _collate
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.ops import gather_rows as gr
    from multimodal_sae_tpu_torch.train import SaeTrainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg_subject = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg_subject, seed=0, dtype=torch.bfloat16, device=dev)
    hook, B, S, L = "layers.24", 8, 2048, 131072
    rng = np.random.default_rng(0)
    rows = [{"input_ids": rng.integers(0, cfg_subject.vocab_size, size=S)} for _ in range(2 * B)]
    batches = [_collate(rows[:B]), _collate(rows[B:])]
    for micro, auxk in SETTINGS:
        cfg = TrainConfig(sae=SaeConfig(num_latents=L, k=256), batch_size=B, grad_acc_steps=4,
                          micro_acc_steps=micro, lr_warmup_steps=0, log_to_wandb=False, hookpoints=[hook],
                          auxk_alpha=1 / 32 if auxk else 0.0)
        line = {"micro_acc_steps": micro, "auxk": auxk}
        trainer = None
        try:
            trainer = SaeTrainer(cfg, rows, model, device=dev)
            if auxk:
                trainer.num_tokens_since_fired[hook][::2] = cfg.dead_feature_threshold + 1
                trainer._refresh_dead_mask(hook)
            torch.cuda.reset_peak_memory_stats()
            line["batch_s"] = []
            for batch in batches:
                t0 = time.perf_counter()
                trainer.step(batch)
                torch.cuda.synchronize()
                line["batch_s"].append(time.perf_counter() - t0)
            line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        except torch.cuda.OutOfMemoryError as e:
            line["out_of_memory"] = str(e).splitlines()[0][:160]
        print(json.dumps(line), flush=True)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(0)
    N, k, d = 4096, 256, 4096
    W = torch.randn(L, d, generator=gen, device=dev)
    W /= torch.linalg.vector_norm(W, dim=1, keepdim=True)
    idx = torch.randint(0, L, (N, k), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn(N, d, generator=gen, device=dev)
    got, again = gr.decode_dvals(g, idx, W, torch.float32), gr.decode_dvals(g, idx, W, torch.float32)
    ref = gr.decode_dvals_plain(g, idx, W, torch.float32)
    torch.cuda.synchronize()

    def time_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    distinct = torch.unique(idx).numel()
    print(json.dumps({
        "dvals_random_rows": [N, k], "W": [L, d], "distinct_rows": distinct,
        "equal_bits": bool(torch.equal(got.view(torch.int32), again.view(torch.int32))),
        "max_abs_err": (got - ref).abs().max().item(),
        "err_bound": 2 * d * 2.0 ** -24 * g.abs().sum(-1).max().item() * W.abs().max().item(),
        "kernel_ms": time_ms(lambda: gr.decode_dvals(g, idx, W, torch.float32)),
        "plain_ms": time_ms(lambda: gr.decode_dvals_plain(g, idx, W, torch.float32), iters=2),
        "bound_ms": max((distinct * d + N * d + 2 * N * k) * 4 / 3.35e12, N * k * d / 33.5e12) * 1e3,
        "named_rows_gb": N * k * d * 4 / 1e9,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
