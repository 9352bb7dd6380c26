"""SAE trainer on one CUDA card (multimodal_sae_tpu/train/trainer.py).

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

from ..config import TrainConfig
from ..device import DeviceLike, setup
from ..ops.adam import ScaleByAdam, flatten_state, unflatten_state
from ..ops.adam8bit import ADAM8BIT_FORMAT, ScaleByAdam8bit
from ..ops.geometric_median import geometric_median
from ..sae import Sae, forward, remove_gradient_parallel_to_decoder_directions, set_decoder_norm_to_unit_norm
from ..utils import natsorted
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


def accumulate(
    params: Params, hiddens: torch.Tensor, dead_mask: torch.Tensor, cfg: TrainConfig, mark: Mark = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One batch of one SAE (the JAX trainer's `accumulate`, reference
    trainer.py:347-391): renormalise the decoder in place, run the
    `micro_acc_steps` chunks of `hiddens` (N, d) forward and backward with
    the loss / (grad_acc_steps * micro_acc_steps), each gradient added into
    the parameters' `.grad`, and clip the accumulated gradient by its global
    norm to 1.  `params` are leaf tensors that require grad.  Returns (the
    chunks' fired masks OR-ed, (L,) bool; {"fvu", "auxk",
    "multi_topk_fvu"}: the chunks' sums, device scalars).  `mark(stage)`
    is passed to `forward` and called after "backward" and "clip"."""
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
    fired = torch.zeros(params["b_enc"].shape[0], dtype=torch.bool, device=hiddens.device)
    sums = {key: torch.zeros((), device=hiddens.device) for key in ("fvu", "auxk", "multi_topk_fvu")}
    for chunk in hiddens.reshape(micro, n // micro, hiddens.shape[-1]):
        out = forward(params, chunk, cfg.sae, dead_mask if cfg.auxk_alpha > 0 else None, mark=mark)
        loss = out.fvu + cfg.auxk_alpha * out.auxk_loss + out.multi_topk_fvu / 8
        (loss / acc_steps).backward()
        if mark is not None:
            mark("backward")
        fired |= out.fired
        for key, value in zip(sums, (out.fvu, out.auxk_loss, out.multi_topk_fvu)):
            sums[key] += value.detach()
        del out, loss
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
    """Trains one SAE per hookpoint over a frozen subject, in one process on
    one device (reference trainer.py:67-461).

    Args:
        cfg: TrainConfig (a RunConfig from the CLI).
        dataset: indexable rows {"input_ids": (S,)}, already shuffled.
        model: an ActivationSource (models/api.py) on `device`.
        device: the card (CUDA) unless the caller names another; the
            trainer raises without one.
    """

    def __init__(self, cfg: TrainConfig, dataset, model, device: DeviceLike = None):
        if cfg.distribute_modules:
            raise NotImplementedError(
                "--distribute_modules is not ported yet: ROADMAP.md §1, multi-process and tensor parallelism"
            )
        if cfg.mm_data:
            raise NotImplementedError("--mm_data is not ported yet: ROADMAP.md §1, LLaVA-NeXT, CLIP and the image cache")
        self.device = setup(device)
        self.model = model
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
        print(f"Training on modules: {cfg.hookpoints}")

        self.input_widths = model.resolve_widths(cfg.hookpoints)
        sae_dtype = getattr(torch, cfg.sae_dtype)
        self.saes: Dict[str, Sae] = {}
        for i, hook in enumerate(cfg.hookpoints):
            sae = Sae(self.input_widths[hook], cfg.sae, dtype=sae_dtype, seed=i, device=self.device)
            for t in sae.params.values():
                t.requires_grad_(True)
            self.saes[hook] = sae

        # Per-SAE auto LR: 2e-4 / sqrt(num_latents / 2**14) (reference trainer.py:131).
        self.base_lrs = {name: cfg.lr or 2e-4 / (sae.num_latents / (2**14)) ** 0.5 for name, sae in self.saes.items()}
        lrs = [f"{lr:.2e}" for lr in sorted(set(self.base_lrs.values()))]
        print(f"Learning rates: {lrs}" if len(lrs) > 1 else f"Learning rate: {lrs[0]}")

        # The reference passes batches, not optimizer steps, as the decay
        # horizon (trainer.py:155-157); kept for parity.
        self.num_batches = len(dataset) // cfg.batch_size
        self.schedule = linear_warmup_schedule(cfg.lr_warmup_steps, self.num_batches)
        if cfg.adam_8bit:
            print("Using 8-bit blockwise Adam state")
            self.optimizer = ScaleByAdam8bit(b1=0.9, b2=0.999, eps=1e-8)
        else:
            self.optimizer = ScaleByAdam(b1=0.9, b2=0.999, eps=1e-8)
        self.opt_states = {name: self.optimizer.init(sae.params) for name, sae in self.saes.items()}

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
                print("Weights & Biases not installed, skipping logging.")
                cfg.log_to_wandb = False

        num_sae_params = sum(p.numel() for s in self.saes.values() for p in s.params.values())
        print(f"Number of SAE parameters: {num_sae_params:_}")

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

        with _save_on_preemption(self):
            self._fit_loop(ds, avg_metrics, wandb, log_fn, pbar)
        self.save()
        if pbar is not None:
            pbar.close()

    def _fit_loop(self, ds, avg_metrics, wandb, log_fn, pbar):
        cfg = self.cfg
        for batch in _iter_batches(ds, cfg.batch_size):
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
            if getattr(self, "_preempted", False) and substep == 0:
                # Stop only at a grad-acc boundary: a checkpoint keeps
                # global_step but not a partial window's gradients.
                print("Preemption signal received; checkpointing and stopping.")
                break

    def step(self, batch: dict, avg_metrics=None, mark: Mark = None):
        """One batch: capture the hidden states, accumulate every SAE's
        gradient, and at a grad-acc boundary apply the updates and refresh
        the dead-feature counters (reference trainer.py:275-414).
        `mark(stage)`, when given, is called after "capture", the stages of
        `accumulate`, and at a boundary "apply" and "bookkeeping"."""
        cfg = self.cfg
        hidden_dict = self.model.capture(batch, cfg.hookpoints)
        if mark is not None:
            mark("capture")
        self._num_tokens_in_step += int(np.asarray(batch["input_ids"]).size)

        for name, hiddens in hidden_dict.items():
            if name not in self.saes:
                continue
            sae = self.saes[name]
            hiddens = hiddens.reshape(-1, hiddens.shape[-1]).to(self.device)
            if self.global_step == 0 and not self._b_dec_initialized:
                with torch.no_grad():
                    sae.b_dec.copy_(geometric_median(hiddens))
            dead_mask = self._dead_mask_dev.get(name)
            if dead_mask is None:
                dead_mask = self._refresh_dead_mask(name)
            fired, metrics = accumulate(sae.params, hiddens, dead_mask, cfg, mark=mark)
            prev = self._fired_dev.get(name)
            self._fired_dev[name] = fired if prev is None else prev | fired
            if avg_metrics is not None and cfg.wandb_log_frequency:
                denom = cfg.grad_acc_steps * cfg.micro_acc_steps * cfg.wandb_log_frequency
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
        `run_name` (default "sae-ckpts"), in the JAX trainer's files."""
        path = self.cfg.run_name or "sae-ckpts"
        print("Saving checkpoint")
        os.makedirs(path, exist_ok=True)
        for hook, sae in self.saes.items():
            sae.save_to_disk(f"{path}/{hook}")
        save_file(
            {f"num_tokens_since_fired/{name}": counts for name, counts in self.num_tokens_since_fired.items()},
            f"{path}/state.safetensors",
        )
        for name in self.saes:
            leaves = flatten_state(self.opt_states[name])
            save_file({f"leaf_{i}": t for i, t in enumerate(leaves)}, f"{path}/optimizer_{_safe(name)}.safetensors")
        with open(f"{path}/state.json", "w") as f:
            json.dump(
                {"global_step": self.global_step, "opt_step": self.opt_step, "adam8bit_format": ADAM8BIT_FORMAT}, f
            )
        with open(f"{path}/config.json", "w") as f:
            json.dump(asdict(self.cfg), f)

    def load_state(self, path: str):
        """Resume (reference trainer.py:161-186): step counters, dead-feature
        counts, optimizer states and SAE weights, from a checkpoint either
        package wrote."""
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
        print(f"Resuming training at step {self.global_step} from '{path}'")

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


def _iter_batches(dataset, batch_size: int) -> Iterable[dict]:
    """Sequential fixed-size batches, the last ragged one dropped (the
    dataset is shuffled upstream, reference trainer.py:235-241), collated
    by the cache pipeline's `_batched`."""
    from ..features.cache import _batched

    if not hasattr(dataset, "__getitem__"):
        raise TypeError(
            f"SaeTrainer needs an indexable row dataset (got {type(dataset).__name__}); materialize the "
            "iterable first"
        )
    yield from _batched(dataset, batch_size)
