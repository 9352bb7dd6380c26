"""Preemption across ranks: SIGTERM reaches one rank only, and every rank
still stops at the same grad-acc boundary, rank 0 saving the checkpoint
(the stop flag is OR-ed across ranks at each boundary).  Before that, the
signalled rank broke out alone and its peers waited in the next batch's
collective until the group timed out.  Each case is two gloo ranks with a
20 s group timeout, killed at 45 s."""

import json

import pytest

from multimodal_sae_tpu_torch.sae import Sae

from torch_mp import start_ranks, wait_all

RANK_TIMEOUT_S = 45


@pytest.mark.parametrize("mode", ["dp", "modules"])
def test_sigterm_to_one_rank_stops_every_rank_at_one_boundary(tmp_path, mode):
    run_dir = tmp_path / "run"
    rcs, outs = wait_all(start_ranks("mp_preempt.py", [run_dir, mode]), timeout=RANK_TIMEOUT_S)
    assert rcs == [0, 0], "\n".join(f"--- rank {r} (rc={rc}) ---\n{o[-3000:]}" for r, (rc, o) in enumerate(zip(rcs, outs)))
    stopped = [line for out in outs for line in out.splitlines() if line.startswith("STOPPED")]
    # Rank 1 was signalled at global_step 3; the next boundary is 4 (of 8).
    assert stopped == ["STOPPED rank=0 global_step=4", "STOPPED rank=1 global_step=4"]
    state = json.loads((run_dir / "state.json").read_text())
    assert state["global_step"] == 4 and state["opt_step"] == 2
    hooks = ["layers.0", "layers.1"] if mode == "modules" else ["layers.1"]
    for hook in hooks:
        assert Sae.load_from_disk(run_dir / hook, device="cpu").num_latents == 64
