"""Tensor parallelism of the subject on process groups
(multimodal_sae_tpu/parallel/tensor_parallel.py).

The JAX package places the subject Megatron-style on a ('model',) mesh of
one process's chips and lets XLA insert the all-reduces.  Here one process
drives one card, so `--tp N` is N processes: under torchrun with world W
(a multiple of N), consecutive ranks form a TP group, each rank keeps its
slices of the language model's weights, and the layer body runs on its
heads with the collectives written out (models/llama.py `decoder_layer`):

* q, k, v, gate and up are split by output row of the port's (out, in)
  weights (column-parallel); the rank runs H/N query heads and kvH/N KV
  heads, and I/N of the MLP;
* o and down are split by input column (row-parallel): each rank's product
  is a partial sum of the whole output, and an all-reduce adds them;
* the LM head is split by vocabulary and the logits gathered;
* the embedding, the norms and (for LLaVA-NeXT) the vision tower, projector
  and `image_newline` are replicated.

The partial sums are added in fp32 and rounded once to the activations'
dtype.  XLA adds a bf16 product's partials in bf16; for N = 2 that is the
same number (the fp32 sum of two bf16 values rounds to the bf16 sum), and
fp32 keeps every rank's sum equal for any N.  Every rank of a group gets
the same bits back, so the replicated residual stream stays equal across
the group.

`rank // N` is the data-parallel index that shards the rows of the launch
flows; ranks that share `rank % N` form a data-parallel group, over which
the trainer sums its gradients; each TP group's first rank writes the
outputs.  Under gloo (the CPU, or two ranks on one card, where NCCL refuses
to run) CUDA tensors are staged through pinned host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..utils.misc import process_count, process_index
from .collectives import staging_route

# Split dimension of each layer weight in the port's (out, in) layout; None
# is replicated.  The JAX package's specs shard its (in, out) matrices by the
# same rows and columns of the product.
LAYER_SPLIT_DIMS: Dict[str, Optional[int]] = {
    "q_proj": 0,
    "k_proj": 0,
    "v_proj": 0,
    "gate_proj": 0,
    "up_proj": 0,
    "o_proj": 1,
    "down_proj": 1,
    "input_layernorm": None,
    "post_attention_layernorm": None,
}
TOP_SPLIT_DIMS: Dict[str, Optional[int]] = {"embed_tokens": None, "norm": None, "lm_head": 0}


def llama_param_specs() -> Dict[str, Optional[int]]:
    """The split dimension of every LLaMA weight of the port's layout (layer
    weights by name, then `embed_tokens`, `norm` and `lm_head`): 0 for the
    output rows, 1 for the input columns, None for replicated."""
    return {**LAYER_SPLIT_DIMS, **TOP_SPLIT_DIMS}


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This process's place in a `--tp` layout: its TP group of `size`
    consecutive ranks (`rank` within it), and the data-parallel group of
    the ranks that share `rank % size` (`dp_index` = global rank // size of
    `dp_size`).  A group of one rank is None."""

    size: int
    rank: int
    group: Any
    dp_index: int
    dp_size: int
    dp_group: Any

    @property
    def writes_outputs(self) -> bool:
        return self.rank == 0


_LAYOUTS: Dict[int, TensorParallel] = {}


def check_divisible(cfg, tp: int) -> None:
    """Refuse a `--tp` that does not divide the KV heads (and so the query
    heads, a multiple of them), the MLP width and the vocabulary of the
    language model `cfg`."""
    widths = {"num_key_value_heads": cfg.num_key_value_heads, "intermediate_size": cfg.intermediate_size,
              "vocab_size": cfg.vocab_size}
    bad = {name: n for name, n in widths.items() if n % tp}
    if bad:
        raise ValueError(f"--tp {tp} must divide the subject's {bad}: each rank holds an equal slice of them")


def tensor_parallel_layout(tp: int) -> TensorParallel:
    """The `--tp tp` layout of this process, its groups made on first use.
    Making groups is collective: every rank calls this with the same `tp`
    at the same point, and every rank makes every group, in the same
    order.  Object payloads (the launch flows' merges) travel over the
    world's group, so no subgroup needs a gloo twin."""
    world = process_count()
    if tp < 1 or world % tp:
        raise ValueError(
            f"--tp {tp} needs a world size it divides (torchrun started {world} rank(s)); run "
            f"`torchrun --nproc_per_node <multiple of {tp}>`"
        )
    if tp in _LAYOUTS:
        return _LAYOUTS[tp]
    rank, n_groups = process_index(), world // tp
    tp_ranks = [list(range(g * tp, (g + 1) * tp)) for g in range(n_groups)]
    dp_ranks = [list(range(r, world, tp)) for r in range(tp)]
    groups = {}
    for ranks in tp_ranks + dp_ranks:
        if len(ranks) > 1:
            groups[tuple(ranks)] = dist.new_group(ranks)
    layout = TensorParallel(
        size=tp, rank=rank % tp, group=groups.get(tuple(tp_ranks[rank // tp])),
        dp_index=rank // tp, dp_size=n_groups, dp_group=groups.get(tuple(dp_ranks[rank % tp])),
    )
    _LAYOUTS[tp] = layout
    return layout


def current_layout() -> Optional[TensorParallel]:
    """The `--tp` layout this process set up (None without `--tp`)."""
    return next(iter(_LAYOUTS.values()), None)


# ---- the collectives of the layer body ----------------------------------------

collective_counts = {"all_reduce": 0, "all_gather": 0}
"""Collectives of the layer body and the LM head since the last reset."""


def _staged(t: torch.Tensor, group) -> bool:
    return staging_route(t.device, group) == "host"


def sum_partials(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the TP group of every rank's partial `t`: added in fp32
    and rounded once to `t`'s dtype (module docstring); a new tensor."""
    collective_counts["all_reduce"] += 1
    wire = t.to(torch.float32, copy=True)
    if _staged(t, tp.group):
        host = torch.empty(wire.shape, dtype=torch.float32, pin_memory=True).copy_(wire)
        dist.all_reduce(host, group=tp.group)
        wire.copy_(host)
    else:
        dist.all_reduce(wire, group=tp.group)
    return wire.to(t.dtype)


def gather_last_dim(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every rank's `t` concatenated along the last dimension, in rank
    order."""
    collective_counts["all_gather"] += 1
    staged = _staged(t, tp.group)
    src = t.detach().contiguous()
    if staged:
        src = torch.empty(src.shape, dtype=src.dtype, pin_memory=True).copy_(src)
    parts = [torch.empty_like(src) for _ in range(tp.size)]
    dist.all_gather(parts, src, group=tp.group)
    out = torch.cat(parts, dim=-1)
    return out.to(t.device) if staged else out


class _CopyToTensorParallel(torch.autograd.Function):
    """Identity forward, sum over the group backward: at the input of the
    column-split products, whose gradients are each rank's share."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_partials(g, ctx.tp), None


class _ReduceFromTensorParallel(torch.autograd.Function):
    """Sum over the group forward, identity backward: at the output of the
    row-split products (the gradient of a sum is each partial's).  Not
    `torch.distributed.nn.functional.all_reduce`, whose backward sums again
    and would multiply a replicated gradient by the group's size."""

    @staticmethod
    def forward(ctx, x, tp):
        return sum_partials(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensorParallel(torch.autograd.Function):
    """Gather along the last dimension forward, this rank's slice backward:
    the vocabulary-split logits, whose loss every rank computes alike."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return gather_last_dim(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None


def copy_to_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _CopyToTensorParallel.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _ReduceFromTensorParallel.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _GatherFromTensorParallel.apply(x, tp)


# ---- placement ------------------------------------------------------------------


def is_quantized(w) -> bool:
    """An int8 leaf {"q8", "scale"} (models/quant.py)."""
    return isinstance(w, dict) and "q8" in w


def _to(w, device):
    if device is None:
        return w
    if is_quantized(w):
        return {"q8": w["q8"].to(device), "scale": w["scale"].to(device)}
    return w.to(device)


def _slice(w, dim: Optional[int], tp: int, rank: int, device=None):
    """Rank `rank`'s 1/tp of `w` along `dim` (None: all of it) on `device`,
    as a tensor of its own (the whole one is not kept alive).  A quantised
    leaf splits its int8 matrix alike; its per-output-row scale follows a
    split of the rows and stays whole for a split of the columns (JAX
    tensor_parallel.py:55-66)."""
    if dim is None:
        return _to(w, device)
    if is_quantized(w):
        scale = _slice(w["scale"], 0, tp, rank, device) if dim == 0 else _to(w["scale"], device)
        return {"q8": _slice(w["q8"], dim, tp, rank, device), "scale": scale}
    n = w.shape[dim]
    if n % tp:
        raise ValueError(f"--tp {tp} does not divide dimension {dim} of a {tuple(w.shape)} weight")
    part = w.narrow(dim, rank * (n // tp), n // tp)
    dev = w.device if device is None else torch.device(device)
    return part.clone() if dev == w.device else part.to(dev)


def shard_llama_params(params: dict, tp: int, rank: int, device=None) -> dict:
    """Rank `rank`'s slices of a LLaMA tree (models/llama.py layout, dense or
    int8 leaves) under `--tp tp`, on `device` (default: where they are)."""
    out = {name: _slice(w, TOP_SPLIT_DIMS[name], tp, rank, device) for name, w in params.items() if name != "layers"}
    out["layers"] = [{name: _slice(w, LAYER_SPLIT_DIMS[name], tp, rank, device) for name, w in layer.items()}
                     for layer in params["layers"]]
    return out


def replicate_saes(model, saes) -> None:
    """Every SAE whole on the subject's device, in place (the JAX contract,
    :101-113): each rank of a TP group holds the whole SAE.  A `--dp`
    subject's SAEs sit on its first device and get a copy on each
    replica's device (`sae.dp_replicas`, the SAE itself where a replica
    shares its device), so that each replica's rows are encoded where they
    were captured (`data_parallel.map_rows`).  A no-op for SAEs already
    there."""
    device = getattr(model, "device", None)
    if device is None:
        return
    device = torch.device(device)
    replicas = getattr(model, "dp_replicas", None) or []
    for sae in saes:
        if next(iter(sae.buffers())).device != device:
            sae.to(device)
        if not replicas:
            continue
        copies = {device: sae}
        for r in replicas:
            dev = torch.device(r.device)
            if dev not in copies:
                copies[dev] = type(sae)(sae.d_in, sae.cfg, params=_tree_to(sae.params, dev))
        for dev, copy_ in copies.items():
            copy_.device = dev
        sae.dp_replicas = [copies[torch.device(r.device)] for r in replicas]


def shard_subject_model(model, tp: int, device=None):
    """Wire `--tp tp` from a launch CLI: this rank's slices of the language
    model (LLaMA, or LLaVA-NeXT's, whose vision tower, projector and
    `image_newline` are replicated) on `device` (default: the model's), and
    the layout on the language config (`LlamaConfig.tp`) and on the model
    (`model.tensor_parallel`).  Needs a process group whose world `tp`
    divides.  Returns (model, layout)."""
    from ..models.llama import LlamaConfig

    lm_cfg = model.cfg.text_config if hasattr(model.cfg, "text_config") else model.cfg
    assert isinstance(lm_cfg, LlamaConfig)
    check_divisible(lm_cfg, tp)
    layout = tensor_parallel_layout(tp)
    dev = torch.device(device) if device is not None else model.device
    lm_cfg = dataclasses.replace(lm_cfg, tp=layout)
    if "language_model" in model.params:
        params = {name: (_tree_to(w, dev) if name != "language_model" else None) for name, w in model.params.items()}
        params["language_model"] = shard_llama_params(model.params["language_model"], tp, layout.rank, dev)
        model.cfg = dataclasses.replace(model.cfg, text_config=lm_cfg)
    else:
        params = shard_llama_params(model.params, tp, layout.rank, dev)
        model.cfg = lm_cfg
    model.params = params
    model.device = dev
    model.tensor_parallel = layout
    return model, layout


def _tree_to(tree, device):
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return _to(tree, device)
