"""Rank driver: the collectives and the trainer's tensor helpers in two
gloo processes.  argv: <out_dir> ok | mismatch | dead.

ok: a group brought up before `initialize_distributed` is kept as it is;
barriers; all_gather_objects and gather_objects in rank order, with
uneven payloads and one of 40 MB (over the JAX package's 32 MB chunk);
the attribution CLI's gather_and_merge; the chunked sum all-reduce (a sum,
never an average) and broadcast; the OR of fired masks as a uint8 MAX; the global total
variance against the concatenated rows'; the row gather with uneven row
counts.  Writes `ok.{rank}`.
mismatch: the ranks call barriers of different names; each must raise.
dead: rank 1 exits before the barrier; rank 0's barrier must raise."""

import datetime
import json
import os
import sys

import common  # noqa: F401  (sys.path)

import numpy as np
import torch
import torch.distributed as dist


def main():
    out_dir, mode = sys.argv[1:3]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=common.GROUP_TIMEOUT_S))
    from multimodal_sae_tpu_torch.launch.features.attribution_patching import gather_and_merge
    from multimodal_sae_tpu_torch.launch.utils import shard_info
    from multimodal_sae_tpu_torch.parallel import (
        all_gather_objects, barrier, gather_objects, initialize_distributed, process_count, process_index)
    from multimodal_sae_tpu_torch.train import trainer

    # An existing group is kept: device None would mean NCCL on a card.
    assert initialize_distributed() and dist.get_backend() == "gloo"
    assert (process_index(), process_count()) == shard_info() == (rank, world) == (rank, 2)

    if mode == "dead":
        if rank == 1:
            os._exit(0)
        try:
            barrier("after_peer_died")
        except Exception as e:  # noqa: BLE001  (the message is what the test reads)
            print(f"barrier raised {type(e).__name__}: {e}", flush=True)
            sys.exit(3)
        sys.exit(0)
    if mode == "mismatch":
        try:
            barrier(f"name_of_rank_{rank}")
        except RuntimeError as e:
            print(f"mismatch raised: {e}", flush=True)
            # The gather behind the barrier completed on both ranks: take
            # the group down before exiting, since gloo's threads can abort
            # an interpreter that exits under them.
            dist.destroy_process_group()
            sys.exit(4)
        sys.exit(0)

    barrier("start")
    everyone = all_gather_objects({"rank": rank} if rank == 0 else list(range(10_000)))
    assert everyone == [{"rank": 0}, list(range(10_000))]
    rooted = gather_objects({"r": rank})
    assert rooted == ([{"r": 0}, {"r": 1}] if rank == 0 else None)
    big = [np.full((40 << 20) // 4 + 13 * rank, rank, np.float32)]
    got = all_gather_objects(big)
    assert [g[0].size for g in got] == [(40 << 20) // 4, (40 << 20) // 4 + 13]
    assert all((g[0] == r).all() for r, g in enumerate(got))

    merged = gather_and_merge({"layers.1": np.full((2, 4), rank, np.float32)})
    if rank == 0:
        np.testing.assert_array_equal(merged["layers.1"], np.repeat([[0.0], [1.0]], [2, 2], axis=0) * np.ones(4))
    else:
        assert merged is None

    # Sums in chunks, not averages.
    trainer.ALL_REDUCE_CHUNK = 7
    t = torch.arange(30, dtype=torch.float32) * (rank + 1)
    trainer.all_reduce_sum_(t)
    assert torch.equal(t, torch.arange(30, dtype=torch.float32) * 3)
    t = torch.arange(30, dtype=torch.float32) + rank
    assert torch.equal(trainer.broadcast_from_rank0_(t), torch.arange(30, dtype=torch.float32))
    # The OR of masks that differ by rank.
    mask = torch.tensor([rank == 0, rank == 1, False, True])
    assert trainer.any_across_ranks(mask).tolist() == [True, True, False, True]
    # The global total variance and the row gather, with uneven rows.
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((5, 3)).astype(np.float32) + 2, rng.standard_normal((3, 3)).astype(np.float32)]
    x = torch.from_numpy(rows[rank])
    allx = np.concatenate(rows).astype(np.float64)
    want = ((allx - allx.mean(axis=0)) ** 2).sum()
    got = float(trainer.global_total_variance(x))
    assert abs(got - want) <= 1e-5 * want, (got, want)
    assert torch.equal(trainer.all_gather_rows(x), torch.from_numpy(np.concatenate(rows)))

    barrier("end")
    with open(os.path.join(out_dir, f"ok.{rank}"), "w") as f:
        json.dump({"rank": rank}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
