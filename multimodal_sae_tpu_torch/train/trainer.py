"""SAE trainer on CUDA cards (multimodal_sae_tpu/train/trainer.py).

One process trains one SAE per hookpoint over a frozen subject.  A batch:
capture the hookpoints' hidden states; per SAE, renormalise the decoder
(stored back), run the micro chunks forward and backward with the loss
divided by the accumulation steps, OR the chunks' fired masks and clip the
accumulated gradient by its global norm; at a grad-acc boundary, project the
decoder's gradient off its rows, take an Adam step at the warm-up schedule's
learning rate, reset the gradient and refresh the dead-feature counters
(reference trainer.py:188-461, step for step).  b_dec starts at the
geometric median of the first batch's hidden states.

The gradient accumulator is each parameter's `.grad`: autograd adds every
micro chunk's gradient into it in place, as the JAX trainer adds into its
`grad_accs`.  Checkpoints keep the JAX trainer's files, names and leaf
order, so either package resumes the other's:

    {run}/{hookpoint}/sae.safetensors + cfg.json
    {run}/state.safetensors        num_tokens_since_fired/{hookpoint} (int64)
    {run}/optimizer_{hookpoint with / and . as _}.safetensors   leaf_{i}
    {run}/state.json               global_step, opt_step, adam8bit_format
    {run}/config.json              json.dump(asdict(cfg))

Data parallelism across processes follows the JAX trainer's multi-process
semantics (one global batch over its mesh), one rank a card: every rank
starts from rank 0's parameters (the optimizer state starts at zero); b_dec
starts at the geometric median of the global first batch (every rank's
hidden states gathered in rank order); the FVU, AuxK and Multi-TopK
denominators are the global batch's total variance, in two passes (the
global mean from summed sums and counts, then the summed squared
deviations); each rank's backward gives the gradient of its share of the
global loss, and the shares are summed across ranks (not averaged) before
the clip; the fired masks are OR-ed at each grad-acc boundary; the
dead-feature counters count each rank's own `input_ids` (JAX
trainer.py:556, as the reference does); rank 0 saves between barriers.
With micro_acc_steps > 1 a micro chunk is every rank's chunk of that
index (the JAX trainer splits the global array into contiguous chunks,
which would put whole ranks in different chunks).

With `distribute_modules` the ranks shard the hookpoints instead
(train/module_sharded.py): each rank builds and trains only its own SAEs,
on the global batch's rows of its hookpoints that one all-to-all a batch
brings it, so its FVU denominator is that batch's own variance and no
gradient crosses ranks.  Each rank counts its own `input_ids`, as under
data parallelism, while its fired masks cover the global batch.  Every
rank writes its own SAE and optimizer files; rank 0 gathers the counters
and writes the shared files, so the checkpoint has a world-1 run's layout.

Under any multi-process run the preemption flag is OR-ed across ranks at
each grad-acc boundary, so that every rank stops at the same one.

Under `--tp N` (a subject with `tensor_parallel`) the ranks of a TP group
capture together, and each trains the SAEs on the group's hidden states,
which are equal on every rank of it: the data-parallel sums above run
over the ranks that share `rank % N` (one per group), the preemption OR
over every rank, and only the global rank 0 saves.  With
`distribute_modules` as well, the hookpoints shard over the N ranks of a
TP group instead of the world (no rows move: each rank holds its group's),
the ranks that share `rank % N` train their block data-parallel as above,
and the first TP group's ranks write their SAEs.  A `--dp` subject's
capture gathers its replicas' rows on the trainer's device.  `fit` runs
inside `maybe_trace("sae_train")` (utils/profiling.py).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import asdict
from fnmatch import fnmatchcase
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..device import DeviceLike, setup
from ..ops.adam import ScaleByAdam, flatten_state, unflatten_state
from ..ops.adam8bit import ADAM8BIT_FORMAT, ScaleByAdam8bit
from ..ops.geometric_median import geometric_median
from ..sae import Sae, forward, remove_gradient_parallel_to_decoder_directions, set_decoder_norm_to_unit_norm
from ..parallel import barrier, gather_objects
from .module_sharded import module_plan, scatter_hiddens
from ..utils import maybe_trace, natsorted, process_count, process_index, rank0_print
from ..utils.safetensors_io import load_file, save_file

Params = Dict[str, torch.Tensor]
Mark = Optional[Callable[[str], None]]


def linear_warmup_schedule(warmup_steps: int, total_steps: int):
    """transformers.get_linear_schedule_with_warmup semantics (reference
    trainer.py:155-157): linear 0 -> 1 over the warm-up, then linear decay
    to 0 at total_steps, in fp32 host arithmetic as the JAX trainer does.
    Step 0 gives 0 whenever warmup_steps > 0."""

    def schedule(step):
        step = np.float32(step)
        warm = step / np.maximum(np.float32(1.0), np.float32(warmup_steps))
        decay = np.maximum(
            np.float32(0.0),
            (np.float32(total_steps) - step)
            / np.maximum(np.float32(1.0), np.float32(total_steps - warmup_steps)),
        )
        return float(warm if step < warmup_steps else decay)

    return schedule


def _global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, summed leaf by leaf
    in sorted-name order (jax.tree_util's order for a dict)."""
    return torch.sqrt(sum(torch.sum(torch.square(grads[name])) for name in sorted(grads)))


# Elements one collective call moves: gloo stages a CUDA tensor through a
# host copy of it, which this bounds (1 GiB of fp32).
ALL_REDUCE_CHUNK = 1 << 28


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` (contiguous) across the ranks of `group` (default: all), in
    place, in chunks of ALL_REDUCE_CHUNK elements."""
    for part in t.view(-1).split(ALL_REDUCE_CHUNK):
        dist.all_reduce(part, group=group)
    return t


def broadcast_from_rank0_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The first rank of `group`'s `t` (contiguous; default: rank 0's) on
    every rank of it, in place, in chunks."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for part in t.view(-1).split(ALL_REDUCE_CHUNK):
        dist.broadcast(part, src=src, group=group)
    return t


def global_total_variance(x: torch.Tensor, group=None) -> torch.Tensor:
    """sum((x - mean(x))^2) over every rank's rows of `x` (N, d) in `group`,
    in two passes: the global mean from the summed row sums and counts,
    then the summed squared deviations (never E[x^2] - E[x]^2, which
    cancels)."""
    sums = torch.cat([x.sum(dim=0, dtype=torch.float64), x.new_tensor([x.shape[0]], dtype=torch.float64)])
    all_reduce_sum_(sums, group)
    mean = (sums[:-1] / sums[-1]).to(x.dtype)
    return all_reduce_sum_(torch.sum((x - mean) ** 2).reshape(1), group)[0]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of `x` (N_r, ...) in `group`, concatenated in rank
    order; the ranks' N_r may differ."""
    world = dist.get_world_size(group)
    n = torch.tensor([x.shape[0]], device=x.device)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    padded = x.new_zeros((max(counts),) + tuple(x.shape[1:]))
    padded[: x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([part[:c] for part, c in zip(parts, counts)])


def any_across_ranks(mask: torch.Tensor, group=None) -> torch.Tensor:
    """The OR of a bool mask across the ranks of `group`, as a uint8 MAX
    (a bool all-reduce's meaning depends on the backend and version)."""
    as_u8 = mask.to(torch.uint8)
    dist.all_reduce(as_u8, op=dist.ReduceOp.MAX, group=group)
    return as_u8.bool()


def accumulate(
    params: Params,
    hiddens: torch.Tensor,
    dead_mask: torch.Tensor,
    cfg: TrainConfig,
    mark: Mark = None,
    data_parallel: bool = False,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One batch of one SAE (the JAX trainer's `accumulate`, reference
    trainer.py:347-391): renormalise the decoder in place, run the
    `micro_acc_steps` chunks of `hiddens` (N, d) forward and backward with
    the loss / (grad_acc_steps * micro_acc_steps), each gradient added into
    the parameters' `.grad`, and clip the accumulated gradient by its global
    norm to 1.  `params` are leaf tensors that require grad.  Returns (the
    chunks' fired masks OR-ed, (L,) bool; {"fvu", "auxk",
    "multi_topk_fvu"}: the chunks' sums, device scalars).  With
    `data_parallel`, `hiddens` are this rank's rows of the global batch:
    each chunk's losses take the global chunk's total variance, and this
    batch's gradients are summed across ranks before they join the
    accumulator and the clip; the fired masks and sums stay this rank's.
    The ranks are `group`'s (default: all).  `mark(stage)` is passed to `forward` and called after "backward",
    "all_reduce" (data-parallel) and "clip"."""
    if cfg.sae.normalize_decoder:
        set_decoder_norm_to_unit_norm(params)
    micro = cfg.micro_acc_steps
    n = hiddens.shape[0]
    if n % micro != 0:
        raise ValueError(
            f"batch tokens ({n}) must be divisible by micro_acc_steps ({micro}): pick "
            "batch_size * ctx_len divisible by it"
        )
    acc_steps = cfg.grad_acc_steps * micro
    held = {}
    if data_parallel:  # the window's summed gradient so far; this batch's is summed apart
        held = {name: p.grad for name, p in params.items()}
        for p in params.values():
            p.grad = None
    fired = torch.zeros(params["b_enc"].shape[0], dtype=torch.bool, device=hiddens.device)
    sums = {key: torch.zeros((), device=hiddens.device) for key in ("fvu", "auxk", "multi_topk_fvu")}
    for chunk in hiddens.reshape(micro, n // micro, hiddens.shape[-1]):
        tv = global_total_variance(chunk.to(params["W_enc"].dtype), group) if data_parallel else None
        out = forward(params, chunk, cfg.sae, dead_mask if cfg.auxk_alpha > 0 else None, mark=mark,
                      total_variance=tv)
        loss = out.fvu + cfg.auxk_alpha * out.auxk_loss + out.multi_topk_fvu / 8
        (loss / acc_steps).backward()
        if mark is not None:
            mark("backward")
        fired |= out.fired
        for key, value in zip(sums, (out.fvu, out.auxk_loss, out.multi_topk_fvu)):
            sums[key] += value.detach()
        del out, loss
    if data_parallel:
        with torch.no_grad():
            for name in sorted(params):
                grad = all_reduce_sum_(params[name].grad, group)
                if held[name] is not None:
                    grad.add_(held[name])
        if mark is not None:
            mark("all_reduce")
    with torch.no_grad():  # clip_grad_norm_(1.0), every batch (reference trainer.py:391)
        grads = {name: p.grad for name, p in params.items()}
        scale = torch.clamp(1.0 / (_global_norm(grads) + 1e-6), max=1.0)
        for g in grads.values():
            g.mul_(scale)
    if mark is not None:
        mark("clip")
    return fired, sums


@torch.no_grad()
def apply_updates(params: Params, opt_state, optimizer, lr: float, normalize_decoder: bool):
    """Project, Adam, step by -lr, reset the accumulator (the JAX trainer's
    `apply_updates`, reference trainer.py:393-402), in place on `params`;
    returns the new optimizer state."""
    grads = {name: p.grad for name, p in params.items()}
    if normalize_decoder:
        remove_gradient_parallel_to_decoder_directions(params, grads)
    updates, opt_state = optimizer.update(grads, opt_state)
    for name, p in params.items():
        p.add_(updates[name].mul_(-lr))
        p.grad = None
    return opt_state


class SaeTrainer:
    """Trains one SAE per hookpoint over a frozen subject, one process on
    one device (reference trainer.py:67-461); data-parallel, or
    module-sharded under `cfg.distribute_modules` (module docstring), when a
    process group of more than one rank is up.

    Args:
        cfg: TrainConfig (a RunConfig from the CLI).
        dataset: indexable rows {"input_ids": (S,)}, already shuffled (and
            this rank's shard of them under data parallelism).
        model: an ActivationSource (models/api.py) on `device`.
        device: the card (CUDA) unless the caller names another; the
            trainer raises without one.
        collator: turns a list of `batch_size` rows into a batch (e.g.
            `DataCollatorForImage` for multimodal rows, whose images the
            LLaVA subject's `capture` prepares); None stacks the rows.
    """

    def __init__(self, cfg: TrainConfig, dataset, model, device: DeviceLike = None, collator=None):
        self.device = setup(device)
        self.model = model
        self.collator = collator
        all_names = model.hookpoint_names()

        if cfg.hookpoints:
            if cfg.layers:
                raise ValueError("Cannot specify both `hookpoints` and `layers`.")
            raw = [name for name in all_names if any(fnmatchcase(name, pat) for pat in cfg.hookpoints)]
            cfg.hookpoints = natsorted(raw)
        else:
            if not cfg.layers:
                cfg.layers = list(range(0, len(all_names), cfg.layer_stride))
            layers_name = model.layers_name()
            cfg.hookpoints = [f"{layers_name}.{i}" for i in cfg.layers]
            missing = [h for h in cfg.hookpoints if h not in all_names]
            if missing:
                raise ValueError(
                    f"--layers resolved to hookpoint(s) {missing} that do not exist on the subject (it has "
                    f"{len(all_names)} layers; --truncate_layers drops layers from the top)"
                )
        if not cfg.hookpoints:
            raise ValueError(
                "no hookpoints resolved — check --hookpoints patterns / --layers against the model's "
                f"modules (e.g. {all_names[:3]}...)"
            )
        self.cfg = cfg
        self.dataset = dataset
        self.input_widths = model.resolve_widths(cfg.hookpoints)
        # The ranks that hold other rows of the global batch: under --tp, one
        # rank of each TP group (those that share rank % N); else every rank.
        layout = getattr(model, "tensor_parallel", None)
        self.dp_group = layout.dp_group if layout is not None else None
        dp_size = layout.dp_size if layout is not None else process_count()
        # One plan entry per member under distribute_modules (the hookpoints
        # it owns): the world's ranks, exchanging rows; or under --tp the TP
        # group's ranks, which hold the group's rows already, each block
        # trained data-parallel by the ranks that share rank % N.  None when
        # every rank trains every hookpoint.
        self.module_plan, self._plan_index, self._exchange = None, 0, False
        if cfg.distribute_modules:
            if layout is not None:
                members, self._plan_index, group = layout.size, layout.rank, f"ranks of a --tp {layout.size} group"
            else:
                members, self._plan_index, group = process_count(), process_index(), "ranks of the world"
                self._exchange = True
            self.module_plan = module_plan(cfg.hookpoints, self.input_widths, members, group=group)
        self.data_parallel = dp_size > 1 and (self.module_plan is None or layout is not None)
        if self.module_plan is None:
            rank0_print(f"Training on modules: {cfg.hookpoints}")
        else:
            member = "TP rank" if layout is not None else "Rank"
            for r, hooks in enumerate(self.module_plan):
                rank0_print(f"{member} {r} modules: {hooks}")

        sae_dtype = getattr(torch, cfg.sae_dtype)
        self.saes: Dict[str, Sae] = {}
        local = set(self.local_hookpoints())
        for i, hook in enumerate(cfg.hookpoints):  # seeded by the global index: any world draws the same SAE
            if hook not in local:
                continue
            sae = Sae(self.input_widths[hook], cfg.sae, dtype=sae_dtype, seed=i, device=self.device)
            for t in sae.params.values():
                t.requires_grad_(True)
            self.saes[hook] = sae

        # Per-SAE auto LR: 2e-4 / sqrt(num_latents / 2**14) (reference trainer.py:131).
        self.base_lrs = {name: cfg.lr or 2e-4 / (sae.num_latents / (2**14)) ** 0.5 for name, sae in self.saes.items()}
        lrs = [f"{lr:.2e}" for lr in sorted(set(self.base_lrs.values()))]
        rank0_print(f"Learning rates: {lrs}" if len(lrs) > 1 else f"Learning rate: {lrs[0]}")

        # The reference passes batches, not optimizer steps, as the decay
        # horizon (trainer.py:155-157); kept for parity.
        self.num_batches = len(dataset) // cfg.batch_size
        self.schedule = linear_warmup_schedule(cfg.lr_warmup_steps, self.num_batches)
        if cfg.adam_8bit:
            rank0_print("Using 8-bit blockwise Adam state")
            self.optimizer = ScaleByAdam8bit(b1=0.9, b2=0.999, eps=1e-8)
        else:
            self.optimizer = ScaleByAdam(b1=0.9, b2=0.999, eps=1e-8)
        self.opt_states = {name: self.optimizer.init(sae.params) for name, sae in self.saes.items()}
        if self.data_parallel:
            # Every rank starts from rank 0's parameters, as DDP does (the
            # optimizer state starts at zero everywhere).
            with torch.no_grad():
                for sae in self.saes.values():
                    for name in sorted(sae.params):
                        broadcast_from_rank0_(sae.params[name], self.dp_group)

        self.global_step = 0
        self.opt_step = 0  # optimizer updates so far
        self.num_tokens_since_fired = {name: np.zeros(sae.num_latents, dtype=np.int64) for name, sae in self.saes.items()}
        self._did_fire = {name: np.zeros(sae.num_latents, dtype=bool) for name, sae in self.saes.items()}
        # Fired masks are OR-ed on the device and read once per grad-acc
        # boundary; the dead mask changes only there, so one device copy
        # serves the window.
        self._fired_dev: Dict[str, torch.Tensor] = {}
        self._dead_mask_dev: Dict[str, torch.Tensor] = {}
        self._num_tokens_in_step = 0
        self._b_dec_initialized = False  # set on resume / after step 0

    def local_hookpoints(self):
        """The hookpoints this rank trains: its block of the module plan, or
        every hookpoint."""
        return self.module_plan[self._plan_index] if self.module_plan is not None else self.cfg.hookpoints

    def _refresh_dead_mask(self, name: str) -> torch.Tensor:
        """The device's dead mask from the host counters (at grad-acc
        boundaries, on first use and after a resume)."""
        mask = self.num_tokens_since_fired[name] > self.cfg.dead_feature_threshold
        self._dead_mask_dev[name] = torch.from_numpy(mask).to(self.device)
        return self._dead_mask_dev[name]

    # ------------------------------------------------------------------ train
    def fit(self, log_fn=None):
        cfg = self.cfg
        wandb = None
        if cfg.log_to_wandb and log_fn is None:
            try:
                import wandb as _wandb

                _wandb.init(name=cfg.run_name, project="sae", config=asdict(cfg), save_code=True)
                wandb = _wandb
            except ImportError:
                rank0_print("Weights & Biases not installed, skipping logging.")
                cfg.log_to_wandb = False

        num_sae_params = sum(p.numel() for s in self.saes.values() for p in s.params.values())
        rank0_print(f"Number of SAE parameters: {num_sae_params:_}")

        ds = self.dataset
        if self.global_step > 0:
            ds = ds.select(range(self.global_step * cfg.batch_size, len(self.dataset)))
        # Metrics cost a device read per batch: kept only for a sink.
        avg_metrics = (
            {name: defaultdict(float) for name in self.saes} if (wandb is not None or log_fn is not None) else None
        )
        pbar = None
        try:
            from tqdm.auto import tqdm

            pbar = tqdm(desc="Training", initial=self.global_step, total=self.num_batches)
        except ImportError:
            pass

        with maybe_trace("sae_train"), _save_on_preemption(self):
            self._fit_loop(ds, avg_metrics, wandb, log_fn, pbar)
        self.save()
        if pbar is not None:
            pbar.close()

    def _fit_loop(self, ds, avg_metrics, wandb, log_fn, pbar):
        cfg = self.cfg
        for batch in _iter_batches(ds, cfg.batch_size, collator=self.collator):
            self.step(batch, avg_metrics)

            step, substep = divmod(self.global_step, cfg.grad_acc_steps)
            if avg_metrics is not None and substep == 0 and cfg.wandb_log_frequency and (
                step % cfg.wandb_log_frequency == 0
            ):
                info = {}
                for name in self.saes:
                    mask = self.num_tokens_since_fired[name] > cfg.dead_feature_threshold
                    info[f"fvu/{name}"] = avg_metrics[name]["fvu"]
                    info[f"dead_pct/{name}"] = float(mask.mean())
                    if cfg.auxk_alpha > 0:
                        info[f"auxk/{name}"] = avg_metrics[name]["auxk"]
                    if cfg.sae.multi_topk:
                        info[f"multi_topk_fvu/{name}"] = avg_metrics[name]["multi_topk_fvu"]
                    avg_metrics[name].clear()
                if wandb is not None:
                    wandb.log(info, step=step)
                if log_fn is not None:
                    log_fn(step, info)

            if substep == 0 and step % cfg.save_every == 0:
                self.save()
            if pbar is not None:
                pbar.update()
            if substep == 0 and self._stop_requested():
                # Stop only at a grad-acc boundary: a checkpoint keeps
                # global_step but not a partial window's gradients.
                rank0_print("Preemption signal received; checkpointing and stopping.")
                break

    def _stop_requested(self) -> bool:
        """Whether any rank has caught a preemption signal (this process's
        flag alone at world 1).  Every rank, TP peers included, calls this at
        every grad-acc boundary, so they all stop at the same one."""
        flag = getattr(self, "_preempted", False)
        if process_count() == 1:
            return flag
        return bool(any_across_ranks(torch.tensor([flag], device=self.device))[0])

    def step(self, batch: dict, avg_metrics=None, mark: Mark = None):
        """One batch: capture the hidden states, accumulate every SAE's
        gradient, and at a grad-acc boundary apply the updates and refresh
        the dead-feature counters (reference trainer.py:275-414).  The
        tokens counted toward the dead-feature threshold are the batch's
        `input_ids` positions, pads included (an un-expanded `<image>`
        placeholder counts once); every captured row trains, pad rows of a
        ragged multimodal batch included, as in the JAX trainer.
        `mark(stage)`, when given, is called after "capture", "exchange"
        (module-sharded), the stages of `accumulate`, and at a boundary
        "apply" and "bookkeeping".  Under `distribute_modules` every
        hookpoint is captured, and exchanged (except under `--tp`), before
        this rank's SAEs train."""
        cfg = self.cfg
        hidden_dict = self.model.capture(batch, cfg.hookpoints)
        if mark is not None:
            mark("capture")
        if self._exchange:
            hidden_dict = scatter_hiddens({name: h.reshape(-1, h.shape[-1]) for name, h in hidden_dict.items()},
                                          self.module_plan, process_index())
            if mark is not None:
                mark("exchange")
        self._num_tokens_in_step += int(np.asarray(batch["input_ids"]).size)

        for name, hiddens in hidden_dict.items():
            if name not in self.saes:
                continue
            sae = self.saes[name]
            hiddens = hiddens.reshape(-1, hiddens.shape[-1]).to(self.device)
            if self.global_step == 0 and not self._b_dec_initialized:
                with torch.no_grad():
                    sae.b_dec.copy_(geometric_median(
                        all_gather_rows(hiddens, self.dp_group) if self.data_parallel else hiddens))
            dead_mask = self._dead_mask_dev.get(name)
            if dead_mask is None:
                dead_mask = self._refresh_dead_mask(name)
            fired, metrics = accumulate(sae.params, hiddens, dead_mask, cfg, mark=mark,
                                        data_parallel=self.data_parallel, group=self.dp_group)
            prev = self._fired_dev.get(name)
            self._fired_dev[name] = fired if prev is None else prev | fired
            if avg_metrics is not None and cfg.wandb_log_frequency:
                denom = cfg.grad_acc_steps * cfg.micro_acc_steps * cfg.wandb_log_frequency
                if self.data_parallel:  # each rank's sums are its shares of the global losses
                    metrics = dict(zip(metrics, all_reduce_sum_(torch.stack(list(metrics.values())), self.dp_group)))
                for key, value in metrics.items():
                    avg_metrics[name][key] += float(value) / denom
        self._b_dec_initialized = True

        step, substep = divmod(self.global_step + 1, cfg.grad_acc_steps)
        if substep == 0:
            lr_scale = self.schedule(self.opt_step)
            for name, sae in self.saes.items():
                lr = self.base_lrs[name] * lr_scale
                self.opt_states[name] = apply_updates(
                    sae.params, self.opt_states[name], self.optimizer, lr, cfg.sae.normalize_decoder
                )
            self.opt_step += 1
            if mark is not None:
                mark("apply")
            # Dead-feature bookkeeping (reference trainer.py:404-414): the
            # window's fired mask is read back here, once per boundary.
            for name, counts in self.num_tokens_since_fired.items():
                counts += self._num_tokens_in_step
                fired_dev = self._fired_dev.pop(name, None)
                if fired_dev is not None:
                    if self.data_parallel:
                        fired_dev = any_across_ranks(fired_dev, self.dp_group)
                    self._did_fire[name] |= fired_dev.cpu().numpy()
                counts[self._did_fire[name]] = 0
                self._did_fire[name][:] = False
                self._refresh_dead_mask(name)
            self._num_tokens_in_step = 0
            if mark is not None:
                mark("bookkeeping")
        self.global_step += 1

    # ------------------------------------------------------------ checkpoints
    def save(self):
        """Write the checkpoint (reference trainer.py:540-569) under
        `run_name` (default "sae-ckpts"), in the JAX trainer's files, then
        pass a barrier on every rank.  Under data parallelism the ranks hold
        equal state and rank 0 writes it all; under module sharding each
        plan member writes its own SAEs and optimizer states (under `--tp`,
        the first TP group's ranks), and rank 0 gathers the members'
        counters and writes the shared files (reference
        trainer.py:546-552)."""
        path = self.cfg.run_name or "sae-ckpts"
        rank = process_index()
        if rank != 0 and self.module_plan is None:
            barrier("trainer_save")
            return
        writers = len(self.module_plan) if self.module_plan is not None else 1
        if rank < writers:  # the plan's members are ranks 0 .. writers - 1 (the first TP group under --tp)
            rank0_print("Saving checkpoint")
            os.makedirs(path, exist_ok=True)
            for hook, sae in self.saes.items():
                sae.save_to_disk(f"{path}/{hook}")
            for name in self.saes:
                leaves = flatten_state(self.opt_states[name])
                save_file({f"leaf_{i}": t for i, t in enumerate(leaves)},
                          f"{path}/optimizer_{_safe(name)}.safetensors")
        counters = self.num_tokens_since_fired
        if self.module_plan is not None:
            gathered = gather_objects(counters)
            if rank != 0:
                barrier("trainer_save")
                return
            counters = {name: c for part in gathered[:writers] for name, c in part.items()}
        save_file(
            {f"num_tokens_since_fired/{name}": counters[name] for name in self.cfg.hookpoints},
            f"{path}/state.safetensors",
        )
        with open(f"{path}/state.json", "w") as f:
            json.dump(
                {"global_step": self.global_step, "opt_step": self.opt_step, "adam8bit_format": ADAM8BIT_FORMAT}, f
            )
        with open(f"{path}/config.json", "w") as f:
            json.dump(asdict(self.cfg), f)
        barrier("trainer_save")

    def load_state(self, path: str):
        """Resume (reference trainer.py:161-186): step counters, dead-feature
        counts, optimizer states and SAE weights, from a checkpoint either
        package wrote; a rank reads only the hookpoints it trains."""
        with open(f"{path}/state.json") as f:
            st = json.load(f)
        if self.cfg.adam_8bit and st.get("adam8bit_format", 1) != ADAM8BIT_FORMAT:
            raise ValueError(
                f"checkpoint at '{path}' stores 8-bit Adam moments in format {st.get('adam8bit_format', 1)}; "
                f"this build reads format {ADAM8BIT_FORMAT} (cube-root-companded m, raw-absmax scales). Resume "
                "with the build that wrote it, or restart the run."
            )
        self.global_step = st["global_step"]
        self.opt_step = st.get("opt_step", self.global_step)
        rank0_print(f"Resuming training at step {self.global_step} from '{path}'")

        state_tensors = load_file(f"{path}/state.safetensors")
        for name in self.saes:
            self.num_tokens_since_fired[name] = state_tensors[f"num_tokens_since_fired/{name}"].numpy().copy()

        for name, sae in self.saes.items():
            loaded = Sae.load_from_disk(f"{path}/{name}", device=self.device)
            for pname, t in loaded.params.items():
                sae.register_buffer(pname, t.requires_grad_(True))
            flat = load_file(f"{path}/optimizer_{_safe(name)}.safetensors")
            like = self.opt_states[name]
            leaves = [flat[f"leaf_{i}"] for i in range(len(flatten_state(like)))]
            self.opt_states[name] = unflatten_state(leaves, like)
        self._b_dec_initialized = True
        # Restored counters invalidate the device's masks.
        self._dead_mask_dev = {}
        self._fired_dev = {}


@contextmanager
def _save_on_preemption(trainer: SaeTrainer):
    """SIGTERM and SIGINT ask the fit loop to checkpoint and stop at the next
    grad-acc boundary; the old handlers come back on exit.  Off the main
    thread this does nothing."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        yield
        return

    trainer._preempted = False

    def handler(signum, frame):
        trainer._preempted = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):  # pragma: no cover
            pass
    try:
        yield
    finally:
        for sig, old in previous.items():
            signal.signal(sig, old)


def _safe(name: str) -> str:
    return name.replace("/", "_").replace(".", "_")


def _iter_batches(dataset, batch_size: int, collator=None) -> Iterable[dict]:
    """Sequential fixed-size batches, the last ragged one dropped (the
    dataset is shuffled upstream, reference trainer.py:235-241): the rows
    in order through `collator`, or without one collated by the cache
    pipeline's `_batched`."""
    from ..features.cache import _batched

    if not hasattr(dataset, "__getitem__"):
        raise TypeError(
            f"SaeTrainer needs an indexable row dataset (got {type(dataset).__name__}); materialize the "
            "iterable first"
        )
    if collator is None:
        yield from _batched(dataset, batch_size)
        return
    for i in range(len(dataset) // batch_size):
        yield collator([dataset[j] for j in range(i * batch_size, (i + 1) * batch_size)])
