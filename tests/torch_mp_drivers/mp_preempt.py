"""Rank driver: `SaeTrainer.fit` on `SyntheticActivationSource(16, 2, 64)`,
data-parallel or module-sharded over the ranks, with a short group
timeout; rank 1 alone sends itself SIGTERM after its third batch.  Every
rank prints the step it stopped at.
argv: <run_dir> <mode: dp | modules>."""

import os
import signal
import sys

import common

import numpy as np

GROUP_TIMEOUT_S = 20.0  # a rank left waiting in a collective fails fast


def main():
    run_dir, mode = sys.argv[1:3]
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.models import SyntheticActivationSource
    from multimodal_sae_tpu_torch.parallel import initialize_distributed, process_index
    from multimodal_sae_tpu_torch.train import SaeTrainer

    initialize_distributed("cpu", timeout=GROUP_TIMEOUT_S)
    rank = process_index()
    rows = [{"input_ids": r} for r in np.random.default_rng(rank).integers(0, 64, size=(16, 8))]
    modules = mode == "modules"
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4), batch_size=2, grad_acc_steps=2,
                      hookpoints=["layers.0", "layers.1"] if modules else ["layers.1"], distribute_modules=modules,
                      run_name=run_dir, log_to_wandb=False, save_every=10_000)
    trainer = SaeTrainer(cfg, rows, SyntheticActivationSource(d_model=16, n_layers=2, vocab=64, device="cpu"),
                         device="cpu")
    if rank == 1:
        step = trainer.step

        def step_then_signal(*args, **kw):
            step(*args, **kw)
            if trainer.global_step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

        trainer.step = step_then_signal
    trainer.fit()
    print(f"STOPPED rank={rank} global_step={trainer.global_step}", flush=True)


if __name__ == "__main__":
    main()
