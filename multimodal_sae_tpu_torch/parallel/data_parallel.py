"""In-process data parallelism, `--dp N` (multimodal_sae_tpu/parallel/data_parallel.py).

The JAX package replicates the subject over the first N local chips of its
one process and commits the flow's batch axis to a ('data',) mesh; GSPMD
then splits every program along it.  Here the subject is copied onto N
devices (`model.dp_replicas`, each a shallow copy of the model with its own
parameters and no replicas of its own), each replica runs its share of the
flow's axis, and the results are gathered on the first device in row order:

* the rows, for the cache, the image cache and training capture
  (`LlamaModel.capture`, `LlavaNextModel.forward` and each geometry group
  of its vision tower, padded by repeating the last row as the JAX
  package's `place_rows_padded` pads them);
* the feature chunk, for fast attribution (`FastAttribution.__call__`);
* the generate batch and its KV cache, for steering (`greedy_generate`).

Replicas on one device share its tensors; the tests place several on the
CPU and `chip_smoke.py` two on one card.  Each SAE has a copy on every
replica's device (`tensor_parallel.replicate_saes`), and the cache encodes
each replica's rows with its own copy (`map_rows` over `sae.dp_replicas`);
an intervention of a replica's rows runs on the first device, where the
SAEs themselves sit (`rows_intervention`).  A `--dp N` cache feeds N x
batch_size rows a step, so its output equals a one-device run at that
batch size (JAX launch/cache/cache.py:60-64).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch

from .tensor_parallel import _tree_to


def shard_subject_model_dp(model, dp: int, devices: Optional[Sequence] = None):
    """Wire `--dp dp` from a launch CLI: copies of the subject on the first
    `dp` CUDA devices, or on `devices` when the caller names them (the
    tests and `chip_smoke.py` place several on one device); the model
    itself moves to the first and keeps the replicas in `dp_replicas`.
    Returns (model, replicas)."""
    if devices is None:
        count = torch.cuda.device_count()
        if dp > count:
            raise ValueError(f"--dp {dp} > local devices ({count})")
        devices = [torch.device("cuda", i) for i in range(dp)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != dp:
        raise ValueError(f"--dp {dp} names {len(devices)} devices")
    if dp < 1:
        raise ValueError(f"--dp must be at least 1, got {dp}")
    model.params = _tree_to(model.params, devices[0])
    model.device = devices[0]
    model.dp_replicas = None
    replicas = []
    for dev in devices:
        replica = copy.copy(model)
        replica.params = _tree_to(model.params, dev)
        replica.device = dev
        replicas.append(replica)
    model.dp_replicas = replicas
    return model, replicas


def replicas_of(model) -> List:
    """The model's `--dp` replicas; [] without them."""
    return getattr(model, "dp_replicas", None) or []


def place_rows(x: torch.Tensor, replicas) -> List[torch.Tensor]:
    """`x`'s rows in len(replicas) equal contiguous parts, part i on
    replica i's device; the row count must divide."""
    n = len(replicas)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} replicas")
    return [part.to(r.device) for part, r in zip(x.split(x.shape[0] // n), replicas)]


def place_rows_padded(x: torch.Tensor, replicas):
    """`place_rows` after padding the rows to a multiple of the replicas by
    repeating the last one; returns (parts, the original row count)."""
    n = x.shape[0]
    pad = -n % len(replicas)
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return place_rows(x, replicas), n


def gather_rows(parts: Sequence[torch.Tensor], device, n: int) -> torch.Tensor:
    """The replicas' row parts concatenated on `device`, the first `n` rows."""
    return torch.cat([p.to(device) for p in parts])[:n]


def map_rows(model, fn: Callable, *rows: Optional[torch.Tensor]):
    """`fn(replica, *its rows)` over the model's replicas (padded rows split
    as `place_rows_padded` splits them; None passes through), the results
    (a tensor, or dicts or tuples of them) gathered on the model's device
    in row order; `fn(model, *rows)` without replicas.  `model` may be an
    SAE with its `--dp` copies (`replicate_saes`)."""
    replicas = replicas_of(model)
    if not replicas:
        return fn(model, *rows)
    n = next(x for x in rows if x is not None).shape[0]
    parts = [place_rows_padded(x, replicas)[0] if x is not None else [None] * len(replicas) for x in rows]
    return _gathered([fn(r, *args) for r, args in zip(replicas, zip(*parts))], model.device, n)


def _gathered(outs: list, device, n: int):
    if isinstance(outs[0], dict):
        return {key: _gathered([o[key] for o in outs], device, n) for key in outs[0]}
    if isinstance(outs[0], tuple):
        return tuple(_gathered(list(col), device, n) for col in zip(*outs))
    return gather_rows(outs, device, n)


def rows_intervention(fn: Callable, start: int, end: int, home) -> Callable:
    """The intervention `fn` of a whole batch, for its rows [start, end)
    held on another replica: a row-aware `fn` (one with `rows(start, end)`,
    as the batched steering clamp) is narrowed to them, and it runs on
    `home`, the SAEs' device.  An `fn` without `rows` acts on each row
    alone."""
    narrow = getattr(fn, "rows", None)
    part = narrow(start, end) if narrow is not None else fn
    return lambda h: part(h.to(home)).to(h.device)
