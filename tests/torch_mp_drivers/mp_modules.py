"""Rank driver: module-sharded `SaeTrainer.fit` (`distribute_modules`) on
`SyntheticActivationSource(16, 2, 64)` at hookpoints layers.0 and layers.1,
one per rank, each rank on its contiguous shard of 16 rows of 8 ids (as the
training CLI shards them), 2 rows a batch; then every rank resumes from the
checkpoint, which must equal its own state bit for bit.  Without torchrun's
environment (the world-1 run) the one process trains both hookpoints on the
same global batches: rank 0's rows, then rank 1's, 4 rows a batch.
argv: <run_dir> [auxk]."""

import sys

import common

import numpy as np
import torch

WORLD, ROWS, BATCH = 2, 16, 2


def main():
    run_dir = sys.argv[1]
    auxk = sys.argv[2:] == ["auxk"]
    rank = common.start()
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.models import SyntheticActivationSource
    from multimodal_sae_tpu_torch.parallel import process_count, shard_dataset_contiguous
    from multimodal_sae_tpu_torch.train import SaeTrainer

    rows = [{"input_ids": r} for r in np.random.default_rng(7).integers(0, 64, size=(ROWS, 8))]
    world = process_count()
    if world == 1:
        per = ROWS // WORLD
        order = [r * per + s * BATCH + i for s in range(per // BATCH) for r in range(WORLD) for i in range(BATCH)]
        rows, batch = [rows[j] for j in order], WORLD * BATCH
    else:
        rows, batch = shard_dataset_contiguous(rows, world, rank)[0], BATCH
    extra = dict(auxk_alpha=1 / 32, dead_feature_threshold=0) if auxk else {}
    cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4, multi_topk=auxk), batch_size=batch, grad_acc_steps=2,
                      lr_warmup_steps=1, hookpoints=["layers.0", "layers.1"], distribute_modules=True,
                      run_name=run_dir, log_to_wandb=False, save_every=10_000, **extra)
    src = SyntheticActivationSource(d_model=16, n_layers=2, vocab=64, device="cpu")
    trainer = SaeTrainer(cfg, rows, src, device="cpu")
    assert list(trainer.saes) == (["layers.0", "layers.1"] if world == 1 else [f"layers.{rank}"])
    trainer.fit()
    held = {hook: {name: t.detach().clone() for name, t in sae.params.items()} for hook, sae in trainer.saes.items()}
    counts = {hook: c.copy() for hook, c in trainer.num_tokens_since_fired.items()}
    trainer.load_state(run_dir)
    assert trainer.global_step == 4 and trainer.opt_step == 2
    for hook, params in held.items():
        assert all(torch.equal(trainer.saes[hook].params[name], t) for name, t in params.items())
        assert np.array_equal(trainer.num_tokens_since_fired[hook], counts[hook])


if __name__ == "__main__":
    main()
