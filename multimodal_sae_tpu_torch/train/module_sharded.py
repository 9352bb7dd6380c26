"""Module-sharded SAE training across processes
(multimodal_sae_tpu/train/module_sharded.py; reference trainer.py:495-538).

With `distribute_modules`, rank r of `world` owns a contiguous block of
len(hookpoints) / world hookpoints (the count must divide, and every
hookpoint must have the same width).  Every rank runs the subject on its
own batch shard and captures every hookpoint; one all-to-all then gives
each rank the whole global batch for its own hookpoints, rank 0's rows
first (`scatter_hiddens`, the reference's `scatter_hiddens`), and each rank
trains only its own SAEs: no gradient all-reduce, no replicated SAE.  At
world 1 every hookpoint trains in the one process.  `SaeTrainer` runs this
form when `TrainConfig.distribute_modules` is set; the JAX package's two
forms (device groups in one process, and `ModuleShardedTrainer` over a
shard_map all-to-all) are this one dataflow on a TPU mesh.

Under `--tp N` every rank of a TP group already holds the group's whole
hidden states, so no row has to move: the plan shards the hookpoints over
the N ranks of a group (by `rank % N`), and the ranks that share `rank % N`,
one in each group, train the same block data-parallel over their rows,
with the trainer's summed gradients (train/trainer.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..parallel.collectives import all_to_all_rows


def module_plan(hookpoints: Sequence[str], widths: Dict[str, int], world: int,
                group: str = "ranks") -> List[List[str]]:
    """The hookpoints each of `world` members owns, in member order:
    contiguous blocks of len(hookpoints) / world (JAX
    train/trainer.py:139-142, :317-323).  `group` names the members in the
    divisibility error (the world's ranks, or a TP group's)."""
    per_rank, rem = divmod(len(hookpoints), world)
    if rem or not per_rank:
        raise ValueError(f"Number of modules must be divisible by the group count: {len(hookpoints)} hookpoint(s) "
                         f"over {world} {group}")
    unique_widths = set(widths[h] for h in hookpoints)
    if len(unique_widths) > 1:
        raise ValueError(
            f"All modules must output tensors of the same shape when using `distribute_modules=True`, got "
            f"{unique_widths}"
        )
    return [list(hookpoints[r * per_rank:(r + 1) * per_rank]) for r in range(world)]


def scatter_hiddens(hiddens: Dict[str, torch.Tensor], plan: List[List[str]], rank: int) -> Dict[str, torch.Tensor]:
    """{hookpoint: this rank's (N_r, d) rows} for every hookpoint -> {own
    hookpoint: the global batch's rows (sum of N_r, d)}, every rank's rows
    in rank order (reference trainer.py:513-538)."""
    if len(plan) == 1:
        return {h: hiddens[h] for h in plan[0]}
    parts = [torch.cat([hiddens[h] for h in hooks]) for hooks in plan]
    got = all_to_all_rows(parts)
    own = plan[rank]
    out = {}
    per_source = [part.split(part.shape[0] // len(own)) for part in got]
    for i, hook in enumerate(own):
        out[hook] = torch.cat([chunks[i] for chunks in per_source])
    return out
