"""LLaMA-3 decoder (multimodal_sae_tpu/models/llama.py): capture, full
forward with interventions and logits, and the suffix forward of
attribution patching.

`llama_forward` returns {"captured", "hidden", "logits"} as the JAX package
does.  A capture-only call (no logits, no hidden) runs no layer above the
deepest hookpoint: the JAX package gets that from XLA's dead-code
elimination, PyTorch runs eagerly, so the loop stops explicitly.  Numerics
follow HF `LlamaModel`: RMSNorm variance and RoPE cos/sin in fp32, softmax
in fp32.  Projection weights keep PyTorch's (out, in) layout (`F.linear`),
as HF checkpoints store them; `convert.py` carries the JAX package's
(in, out) matrices across.  The forward runs under autograd when the caller
differentiates (attribution takes the gradient at a splice); `capture` runs
without it.

With `LlamaConfig.flash_attention` the attention runs through kernel K3
(ops/flash_attention.py, forward and backward); both it and the eager
attention read k and v at kvH heads without repeating them.

Generation (`greedy_generate`) keeps a `KVCache` written in place.  Its
prefill runs K3 over the prompt's own keys with the left-pad key mask where
the JAX package runs eager attention over the whole cache
(multimodal_sae_tpu/models/llama.py:392 takes the flash kernel only without
a cache): the same function, since the slots past the prompt are masked,
and one whose fp32 score tensor, (B, H, S, S + new) a layer, would not fit
at an image prompt.  A decode step attends over the live slots in plain
PyTorch, as the JAX package does outside any Pallas kernel.

With `LlamaConfig.remat` a forward under autograd runs each decoder layer
through non-reentrant `torch.utils.checkpoint`: the backward keeps only
the layers' inputs and recomputes each layer's tape when it reaches it, as
the JAX package wraps `decoder_layer` in `jax.checkpoint`.  Interventions
and capture stay outside the recomputed call, and a cached forward
(generation) is never wrapped.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device, set_precision
from ..ops import flash_attention as fa
from ..parallel.data_parallel import map_rows, replicas_of
from ..parallel.tensor_parallel import copy_to_tp, gather_from_tp, reduce_from_tp
from .quant import leaf_device, leaf_dtype, qembed, qmatmul, tied_head_logits


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    rope_scaling: Optional[Tuple[Tuple[str, float], ...]] = None
    """HF rope_scaling as a sorted (key, value) tuple; only the Llama-3.1
    'llama3' variant is implemented (`from_hf` refuses others)."""

    flash_attention: bool = False
    """Run attention through the causal flash-attention kernel (K3)."""

    int8_matmul: bool = False
    """Run quantised weights through the W8A8 product (models/quant.py
    `qmatmul(int8=True)`: per-row activation quantisation, int8 x int8 ->
    int32).  Ignored for dense weights; W8A16 otherwise."""

    remat: bool = False
    """Recompute each decoder layer in the backward (non-reentrant
    `torch.utils.checkpoint`): the tape keeps only the (B, S, D) layer
    inputs instead of each layer's activations (eager attention's fp32
    scores and probabilities are about 9 GB a layer at an 8-feature chunk
    of a 2,432-token prompt), at the cost of one more forward of the
    layers that the backward crosses."""

    tp: Optional[Any] = field(default=None, compare=False, hash=False, repr=False)
    """The `--tp` layout (parallel/tensor_parallel.py `TensorParallel`) of a
    subject whose weights are this rank's slices; the widths above stay the
    whole model's."""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def local_heads(self) -> Tuple[int, int]:
        """(query heads, KV heads) this rank runs: all of them, or 1/N of
        each under `--tp N`."""
        n = self.tp.size if self.tp is not None else 1
        return self.num_attention_heads // n, self.num_key_value_heads // n

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @classmethod
    def from_hf(cls, d: dict) -> "LlamaConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        rs = d.get("rope_scaling")
        if rs is not None:
            rtype = rs.get("rope_type", rs.get("type"))
            if rtype != "llama3":
                raise NotImplementedError(
                    f"rope_scaling type {rtype!r} is not implemented; "
                    "activations would be silently wrong with default RoPE"
                )
            kw["rope_scaling"] = tuple(
                sorted((k, v) for k, v in rs.items() if isinstance(v, (int, float)))
            )
        if d.get("attention_bias") or d.get("mlp_bias"):
            raise NotImplementedError(
                "attention_bias/mlp_bias checkpoints are not implemented; "
                "activations would be silently wrong without the biases"
            )
        return cls(**kw)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF LlamaRMSNorm: variance in fp32, scale applied in the input dtype."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return x32.to(x.dtype) * weight


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    rope_scaling: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF LlamaRotaryEmbedding: fp32 cos/sin (..., S, head_dim), half-split
    layout; `rope_scaling` applies HF's llama3 frequency rescaling."""
    dev = positions.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    if rope_scaling:
        factor = rope_scaling["factor"]
        low = rope_scaling["low_freq_factor"]
        high = rope_scaling["high_freq_factor"]
        orig = rope_scaling["original_max_position_embeddings"]
        low_wavelen = orig / low
        high_wavelen = orig / high
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig / wavelen - low) / (high - low)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < high_wavelen,
            inv_freq,
            torch.where(wavelen > low_wavelen, scaled, smoothed),
        )
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: (B, H, S, hd); cos/sin: (B, S, hd) or (S, hd).  The product runs
    in fp32 (cos/sin are fp32) and rounds back to q's dtype."""
    cos = cos[..., None, :, :]
    sin = sin[..., None, :, :]
    q = (q * cos + _rotate_half(q) * sin).to(q.dtype)
    k = (k * cos + _rotate_half(k) * sin).to(k.dtype)
    return q, k


@dataclass
class KVCache:
    """The generation loop's cache (multimodal_sae_tpu/models/llama.py
    `KVCache`): k and v of every layer, (layers, B, kvH, max_len, hd) in
    the params' dtype (kvH this rank's heads under `--tp`), and the number
    of slots written.  `llama_forward` writes a block's k and v into these
    buffers in place and returns a KVCache over the same buffers with the
    length advanced."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @staticmethod
    def init(
        cfg: "LlamaConfig",
        batch: int,
        max_len: int,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, cfg.local_heads[1], max_len, cfg.head_dim_)
        dev = resolve_device(device)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))


def causal_mask(
    S: int,
    attention_mask: Optional[torch.Tensor],
    device: torch.device,
    keys: Optional[int] = None,
    offset: int = 0,
) -> torch.Tensor:
    """Additive fp32 mask (B or 1, 1, S, keys): causal plus optional padding
    of the keys.  `offset` is the number of cached tokens before the query
    block; `keys` defaults to S."""
    keys = S if keys is None else keys
    neg = torch.finfo(torch.float32).min
    causal = torch.arange(keys, device=device)[None, :] <= torch.arange(S, device=device)[:, None] + offset
    mask = torch.where(causal, 0.0, neg)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask[:, None, None, :].bool(), 0.0, neg)
        mask = mask + pad
    return mask


def attention(q, k, v, mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Eager attention of q (B, H, S, hd) over k, v (B, kvH, L, hd): fp32
    scores and softmax, the probabilities cast to q's dtype for the PV
    product (HF eager).  Grouped-query heads are a reshape of q to
    (B, kvH, H // kvH * S, hd) against k and v as they are: a decode step
    over a long cache never copies them to H heads."""
    B, H, S, hd = q.shape
    kvH, L = k.shape[1], k.shape[2]
    n_rep = H // kvH
    scores = torch.matmul(q.reshape(B, kvH, n_rep * S, hd).float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = (scores.view(B, kvH, n_rep, S, L) + mask[:, :, None]).view(B, kvH, n_rep * S, L)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).view(B, H, S, hd)


def decoder_layer(
    p: Dict[str, torch.Tensor],
    cfg: LlamaConfig,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    pad_mask: Optional[torch.Tensor],
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_offset: int = 0,
) -> torch.Tensor:
    """One decoder layer.  With `kv`, this layer's cache buffers
    (B, kvH, max_len, hd), the block's k and v are written at
    `cache_offset`; a block at offset 0 with more than one token (the
    prefill) attends over its own keys, any other over the cache's slots up
    to its end.

    Under `--tp` (`cfg.tp`) the layer runs on this rank's heads and MLP
    slice: the norms' outputs enter the column-split products through
    `copy_to_tp` (identity forward, summed gradient backward), and the
    row-split products' partial sums leave through `reduce_from_tp` (summed
    forward, parallel/tensor_parallel.py), so `h` stays whole and equal on
    every rank."""
    B, S, _ = h.shape
    (H, kvH), hd, tp = cfg.local_heads, cfg.head_dim_, cfg.tp
    i8 = cfg.int8_matmul
    x = copy_to_tp(rms_norm(h, p["input_layernorm"], cfg.rms_norm_eps), tp)
    q = qmatmul(x, p["q_proj"], int8=i8).view(B, S, H, hd).transpose(1, 2)
    k = qmatmul(x, p["k_proj"], int8=i8).view(B, S, kvH, hd).transpose(1, 2)
    v = qmatmul(x, p["v_proj"], int8=i8).view(B, S, kvH, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    if kv is not None:
        end = cache_offset + S
        kv[0][:, :, cache_offset:end] = k
        kv[1][:, :, cache_offset:end] = v
        if cache_offset:
            k, v = kv[0][:, :, :end], kv[1][:, :, :end]
    if cfg.flash_attention and S > 1 and not cache_offset:
        attn = fa.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), pad_mask, scale=hd**-0.5
        )
    else:
        attn = attention(q, k, v, mask, hd**-0.5)
    h = h + reduce_from_tp(qmatmul(attn.transpose(1, 2).reshape(B, S, H * hd), p["o_proj"], int8=i8), tp)
    x = copy_to_tp(rms_norm(h, p["post_attention_layernorm"], cfg.rms_norm_eps), tp)
    mlp = F.silu(qmatmul(x, p["gate_proj"], int8=i8)) * qmatmul(x, p["up_proj"], int8=i8)
    return h + reduce_from_tp(qmatmul(mlp, p["down_proj"], int8=i8), tp)


def hookpoint_layer_idx(hookpoint: str) -> int:
    """'model.layers.24' / 'layers.24' -> 24 (loud on anything else)."""
    tail = hookpoint.rsplit(".", 1)[-1]
    if not tail.isdigit():
        raise ValueError(
            f"unsupported hookpoint {hookpoint!r}: only decoder-layer outputs "
            "('layers.N' / 'model.layers.N') can be captured"
        )
    return int(tail)


InterventionFn = Callable[[torch.Tensor], torch.Tensor]


def llama_forward(
    params: dict,
    cfg: LlamaConfig,
    input_ids: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    capture: Sequence[str] = (),
    interventions: Optional[Dict[str, InterventionFn]] = None,
    cache: Optional[KVCache] = None,
    return_logits: bool = True,
    return_hidden: bool = False,
    start_layer: int = 0,
) -> dict:
    """Full forward: {"captured": {hookpoint: (B, S, D) post-layer residual},
    "hidden": final post-norm states (with `return_hidden`), "logits"
    (with `return_logits`), "cache" (with `cache`)}.

    `interventions` {hookpoint: fn} replace layer i's output h by fn(h),
    keyed by layer index (either hookpoint spelling), before it is captured.
    `start_layer > 0` resumes mid-stack: `inputs_embeds` is then the hidden
    state entering layer `start_layer`, and only layers [start_layer,
    num_hidden_layers) run; this is the suffix of attribution patching.
    Without logits or hidden, the loop stops after the deepest hookpoint.

    With `cache` the block's k and v are written at `cache.length` and the
    returned "cache" has its length advanced.  `attention_mask` then covers
    either the whole cache (max_len, as `greedy_generate` passes it) or just
    the block, which is placed at the block's offset; `position_ids`
    default to the block's cache positions."""
    if start_layer and (inputs_embeds is None or cache is not None):
        raise ValueError("start_layer needs inputs_embeds (the state entering that layer) and no cache")
    h = qembed(params["embed_tokens"], input_ids) if inputs_embeds is None else inputs_embeds
    B, S, _ = h.shape
    offset = cache.length if cache is not None else 0
    if position_ids is None:
        position_ids = torch.arange(S, device=h.device)[None, :] + offset
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_dict)
    live = attention_mask
    if cache is not None:
        S_k, filled = cache.k.shape[3], offset + S
        if filled > S_k:
            raise ValueError(f"the cache holds {S_k} slots; {offset} written and {S} more do not fit")
        if attention_mask is not None:
            if attention_mask.shape[1] == S_k:
                live = attention_mask[:, :filled]
            elif attention_mask.shape[1] == S:
                live = torch.ones(B, filled, dtype=attention_mask.dtype, device=attention_mask.device)
                live[:, offset:] = attention_mask
            else:
                raise ValueError(
                    f"attention_mask length {attention_mask.shape[1]} matches "
                    f"neither the input block ({S}) nor the cache ({S_k})"
                )
    if cfg.flash_attention and S > 1 and not offset:
        # Causality and pad-key exclusion happen inside the kernel.
        mask, pad_mask = None, live
    else:
        mask, pad_mask = causal_mask(S, live, h.device, keys=offset + S, offset=offset), None
    iv_by_idx = {hookpoint_layer_idx(k): fn for k, fn in (interventions or {}).items()}
    cap_by_idx = {hookpoint_layer_idx(c): c for c in capture}
    end = cfg.num_hidden_layers
    if not (return_logits or return_hidden):
        end = max(cap_by_idx, default=start_layer - 1) + 1
    if end > len(params["layers"]):
        raise ValueError(f"layer {end - 1} is past the subject's {len(params['layers'])} layers")
    captured = {}
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i in range(start_layer, end):
        if remat:
            h = checkpoint(decoder_layer, params["layers"][i], cfg, h, cos, sin, mask, pad_mask, use_reentrant=False)
        else:
            kv = (cache.k[i], cache.v[i]) if cache is not None else None
            h = decoder_layer(params["layers"][i], cfg, h, cos, sin, mask, pad_mask, kv=kv, cache_offset=offset)
        if i in iv_by_idx:
            h = iv_by_idx[i](h)
        if i in cap_by_idx:
            captured[cap_by_idx[i]] = h
    out = {"captured": captured}
    if cache is not None:
        out["cache"] = KVCache(cache.k, cache.v, offset + S)
    if return_logits or return_hidden:
        h_final = rms_norm(h, params["norm"], cfg.rms_norm_eps)
        if return_hidden:
            out["hidden"] = h_final
        if return_logits:
            out["logits"] = lm_head_logits(params, h_final, int8=cfg.int8_matmul, tp=cfg.tp)
    return out


def lm_head_logits(params: dict, h_final: torch.Tensor, int8: bool = False, tp=None) -> torch.Tensor:
    """Post-norm hidden states -> vocabulary logits, through `lm_head`
    (V, D), dense or quantised (W8A8 with `int8`), or, for a tied head, the
    embedding table.  Under `--tp` (`tp`) the head holds this rank's slice
    of the vocabulary (a column-split product, entered through
    `copy_to_tp`), and every rank gets the whole vocabulary's logits,
    gathered in rank order; a tied head is the replicated embedding."""
    head = params.get("lm_head")
    if head is None:
        return tied_head_logits(params["embed_tokens"], h_final)
    return gather_from_tp(qmatmul(copy_to_tp(h_final, tp), head, int8=int8), tp)


def suffix_params_above(params: dict, layer_idx: int) -> dict:
    """The weights the suffix forward reads: the layers above `layer_idx`,
    final norm and LM head (the tensors themselves, no copies).  The JAX
    package hands these to its jitted suffix so that no slice of the stacked
    weights is copied; here `forward_from_layer_above` reads the layers it
    runs from `params` directly, so nothing on the path needs this dict."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = params["layers"][layer_idx + 1 :]
    return out


def last_attended(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B,) index of each row's last 1: the last real token whichever side
    the padding is on."""
    S = attention_mask.shape[1]
    return S - 1 - torch.argmax(attention_mask.flip(1).to(torch.int32), dim=1)


def forward_from_layer_above(
    params: dict,
    cfg: LlamaConfig,
    hidden: torch.Tensor,
    layer_idx: int,
    attention_mask: Optional[torch.Tensor] = None,
    last_logit_only: bool = True,
) -> torch.Tensor:
    """Resume the forward from layer `layer_idx`'s output `hidden`; only the
    layers above it run.  `last_logit_only` projects only each row's last
    attended position to the vocabulary: (B, 1, V)."""
    out = llama_forward(
        params, cfg, inputs_embeds=hidden, attention_mask=attention_mask,
        start_layer=layer_idx + 1, return_logits=not last_logit_only, return_hidden=last_logit_only,
    )
    if not last_logit_only:
        return out["logits"]
    h = out["hidden"]
    if attention_mask is not None:
        last = last_attended(attention_mask).to(h.device)
        h = h[torch.arange(h.shape[0], device=h.device), last][:, None]
    else:
        h = h[:, -1:]
    return lm_head_logits(params, h, int8=cfg.int8_matmul, tp=cfg.tp)


def pad_text_rows(rows) -> dict:
    """Right-pad ragged token-id rows into a batch dict with an attention
    mask (none when already rectangular, which keeps the attention
    mask-free)."""
    rows = [np.asarray(r, dtype=np.int64).reshape(-1) for r in rows]
    width = max((len(r) for r in rows), default=0)
    if all(len(r) == width for r in rows):
        return {"input_ids": np.stack(rows) if rows else np.zeros((0, 0), np.int64)}
    ids = np.zeros((len(rows), width), dtype=np.int64)
    mask = np.zeros((len(rows), width), dtype=np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def batch_mask(batch: dict, device: torch.device) -> Optional[torch.Tensor]:
    """The batch's attention mask on `device`, or None when it has none or
    masks nothing (all ones), as the JAX side drops it."""
    amask = batch.get("attention_mask")
    if amask is None:
        return None
    amask = np.asarray(amask)
    return None if amask.all() else torch.as_tensor(amask, device=device)


def init_llama_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random init (normal, scaled by fan-in^-0.5 as the JAX package's
    `init_llama_params`) for runs without a checkpoint, drawn on `device`
    from `generator`; an `lm_head` (V, D) unless `tie_word_embeddings`."""
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, kvH, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def mat(shape, scale=None):  # (out, in)
        scale = scale if scale is not None else shape[1] ** -0.5
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    layers = [
        {
            "input_layernorm": torch.ones(D, dtype=dtype, device=device),
            "q_proj": mat((H * hd, D)),
            "k_proj": mat((kvH * hd, D)),
            "v_proj": mat((kvH * hd, D)),
            "o_proj": mat((D, H * hd)),
            "post_attention_layernorm": torch.ones(D, dtype=dtype, device=device),
            "gate_proj": mat((I, D)),
            "up_proj": mat((I, D)),
            "down_proj": mat((D, I)),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    params = {
        "embed_tokens": mat((V, D), scale=0.02),
        "layers": layers,
        "norm": torch.ones(D, dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = mat((V, D), scale=0.02)
    return params


class LlamaModel:
    """Subject shell implementing the ActivationSource protocol
    (models/api.py) over a param tree on one device: this rank's slices
    under `--tp` (parallel/tensor_parallel.py), and with `--dp` replicas
    (`dp_replicas`, parallel/data_parallel.py) that split the rows of
    `capture` and `generate`."""

    def __init__(self, params: dict, cfg: LlamaConfig):
        self.params = params
        self.cfg = cfg
        self.device = leaf_device(params["embed_tokens"])

    @classmethod
    def random(
        cls,
        cfg: LlamaConfig,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
    ) -> "LlamaModel":
        """Random weights at `cfg`'s widths, from a seeded torch.Generator."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(init_llama_params(cfg, gen, dev, dtype), cfg)

    def hookpoint_names(self) -> List[str]:
        return [f"layers.{i}" for i in range(self.cfg.num_hidden_layers)]

    def layers_name(self) -> str:
        return "layers"

    def resolve_widths(self, hookpoints: List[str]) -> Dict[str, int]:
        return {h: self.cfg.hidden_size for h in hookpoints}

    def _ids_and_mask(self, batch: dict):
        ids = torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long).to(self.device)
        return ids, batch_mask(batch, self.device)

    @torch.no_grad()
    def capture(self, batch: dict, hookpoints: List[str]) -> Dict[str, torch.Tensor]:
        """The hookpoints' hidden states; a `--dp` subject's replicas each
        run their share of the rows (`data_parallel.map_rows`)."""
        ids, amask = self._ids_and_mask(batch)
        return map_rows(self, lambda m, ids, amask: llama_forward(
            m.params, self.cfg, ids, attention_mask=amask, capture=tuple(hookpoints), return_logits=False,
        )["captured"], ids, amask)

    def prepare_inputs(self, images=None, input_ids=None, prompt_ids=None) -> dict:
        """Text-only batch from token-id rows, right-padded with an attention
        mask when ragged (the LLaVA subject's `prepare_inputs` contract)."""
        if images is not None:
            raise ValueError(
                "LlamaModel is text-only; image inputs need a LLaVA checkpoint (LlavaNextModel)"
            )
        return pad_text_rows(input_ids if input_ids is not None else prompt_ids)

    def forward(
        self,
        batch: dict,
        capture: Sequence[str] = (),
        interventions: Optional[Dict[str, InterventionFn]] = None,
        return_logits: bool = True,
    ) -> dict:
        """Full forward with capture and interventions (the general SAE-splice
        path's entry point); runs under autograd when the caller's
        interventions carry tensors that require grad."""
        ids, amask = self._ids_and_mask(batch)
        return llama_forward(
            self.params, self.cfg, ids, attention_mask=amask, capture=tuple(capture),
            interventions=interventions, return_logits=return_logits,
        )

    def suffix_params(self, hookpoint: str) -> dict:
        """The weights above `hookpoint`, final norm and LM head (see
        `suffix_params_above`)."""
        return suffix_params_above(self.params, hookpoint_layer_idx(hookpoint))

    def forward_from_layer(
        self,
        hidden: torch.Tensor,
        hookpoint: str,
        batch: dict,
        last_logit_only: bool = True,
    ) -> torch.Tensor:
        """Resume the forward from `hookpoint`'s (possibly spliced) output
        `hidden`; only the layers above it run.  With `last_logit_only`, the
        logits of each row's last attended position, (B, 1, V): the
        logit-diff metric reads nothing else."""
        return forward_from_layer_above(
            self.params, self.cfg, hidden, hookpoint_layer_idx(hookpoint),
            attention_mask=batch_mask(batch, self.device), last_logit_only=last_logit_only,
        )

    # ---- generation ------------------------------------------------------
    def generate(
        self,
        input_ids,
        max_new_tokens: int = 512,
        interventions: Optional[Dict[str, InterventionFn]] = None,
        intervene_prefill_only: bool = True,
        eos_token_id: Union[int, Sequence[int], None] = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: Optional[float] = None,
        seed: int = 0,
        mark: Optional[Callable[[str], None]] = None,
    ) -> torch.Tensor:
        """Greedy (default) or sampled generation through `greedy_generate`
        from token-id rows or a {"input_ids", "attention_mask"} batch
        (left-padded).  `eos_token_id` defaults from the checkpoint's
        `generation_config` (attached by launch.utils.load_subject_model).
        `intervene_prefill_only` applies the interventions at the prefill
        only, as the reference's steering hook skips length-1 calls.
        Returns the prompt ids followed by the new ones, (B, S + new)."""
        if eos_token_id is None:
            eos_token_id = (getattr(self, "generation_config", None) or {}).get("eos_token_id")
        attention_mask = None
        if isinstance(input_ids, dict):
            attention_mask = input_ids.get("attention_mask")
            input_ids = input_ids["input_ids"]
        return greedy_generate(
            self.params, self.cfg, np.asarray(input_ids), max_new_tokens=max_new_tokens,
            interventions=interventions, intervene_prefill_only=intervene_prefill_only,
            eos_token_id=eos_token_id, attention_mask=attention_mask, do_sample=do_sample,
            temperature=temperature, top_p=top_p, seed=seed, mark=mark,
            replicas=[r.params for r in replicas_of(self)],
        )


DONE_CHECK_EVERY = 8
"""The decode loop reads `done.all()` (a host sync) every this many steps;
steps after every row is done write the fill id, as the early exit's tail
fill does, so the output is the same."""


@torch.no_grad()
def greedy_generate(
    params: dict,
    cfg: LlamaConfig,
    input_ids,
    max_new_tokens: int,
    interventions: Optional[Dict[str, InterventionFn]] = None,
    intervene_prefill_only: bool = True,
    eos_token_id: Union[int, Sequence[int], None] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask=None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: Optional[float] = None,
    seed: int = 0,
    mark: Optional[Callable[[str], None]] = None,
    replicas: Optional[Sequence[dict]] = None,
) -> torch.Tensor:
    """Greedy (default) or sampled decode with a KV cache
    (multimodal_sae_tpu/models/llama.py `greedy_generate`): one prefill,
    then one forward of a token per step in a Python loop on the params'
    device.

    `attention_mask` (B, S) supports left-padded batches only: pad keys stay
    masked for the whole generation, prefill positions are cumsum(mask) - 1
    and a step's are the row's real length + step - 1, and the next token
    is read at the last column.  Right padding raises; an all-ones mask is
    dropped.  Only the last position is projected to the vocabulary in the
    prefill.  `eos_token_id` (an int or a list of stop ids): a row that has
    stopped is filled with the first stop id, and so is the tail when every
    row stops early.  `do_sample` draws from the fp32 logits divided by
    `temperature` and filtered by `top_p_filter` (HF's warpers), with a
    torch.Generator on the device seeded by `seed`.  `mark(stage)`, when
    given, is called after the "prefill" and after each "step".

    `replicas`, the parameter trees of a `--dp` subject's replicas
    (parallel/data_parallel.py), split the rows and their KV caches over
    their devices when the batch divides (JAX :1001-1019; else the rows run
    on `params`): each replica runs its rows' prefill and steps, and the
    logits are gathered on `params`' device, where every row's next token
    is chosen, so a draw is the one-device run's.  Interventions are
    narrowed to each replica's rows (`data_parallel.rows_intervention`)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    set_precision()
    device = leaf_device(params["embed_tokens"])
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(device)
    B, S = ids.shape
    am = None
    if attention_mask is not None:
        am = np.asarray(attention_mask).astype(np.int64)
        if am.shape != (B, S):
            raise ValueError(f"attention_mask shape {am.shape} != {(B, S)}")
        if am.all():
            am = None
        elif not (np.diff(am, axis=1) >= 0).all():
            raise ValueError(
                "batched generation requires LEFT-padded inputs (pad tokens "
                "first); right padding would take the next-token logit from "
                "a pad position"
            )
    full_mask = prefill_pos = lengths = None
    if am is not None:
        lengths = torch.as_tensor(am.sum(axis=1), device=device)
        mask_t = torch.as_tensor(am, device=device)
        full_mask = torch.cat([mask_t, torch.ones(B, max_new_tokens, dtype=mask_t.dtype, device=device)], dim=1)
        prefill_pos = (torch.cumsum(mask_t, dim=1) - 1).clamp_min(0)
    if eos_token_id is not None:
        eos = [int(e) for e in eos_token_id] if isinstance(eos_token_id, (list, tuple)) else [int(eos_token_id)]
        eos_token_id = torch.tensor(eos, device=device) if eos else None
    generator = None
    if do_sample:
        if float(temperature) <= 0:
            raise ValueError(
                "do_sample=True requires temperature > 0; use do_sample=False for greedy decoding"
            )
        generator = torch.Generator(device=device).manual_seed(int(seed))
    next_token = _make_next_token_fn(do_sample, temperature, top_p, generator)

    n = len(replicas) if replicas and B % len(replicas) == 0 else 1
    shards = [_GenerateShard(replicas[j] if n > 1 else params, cfg, j * (B // n), (j + 1) * (B // n), device,
                             S + max_new_tokens, interventions, n > 1)
              for j in range(n)]
    logits = []
    for sh in shards:
        out = llama_forward(
            sh.params, cfg, None if inputs_embeds is not None else sh.rows(ids), inputs_embeds=sh.rows(inputs_embeds),
            attention_mask=sh.rows(full_mask), position_ids=sh.rows(prefill_pos), cache=sh.cache,
            interventions=sh.interventions, return_logits=False, return_hidden=True,
        )
        sh.cache = out["cache"]
        logits.append(lm_head_logits(sh.params, out["hidden"][:, -1], int8=cfg.int8_matmul, tp=cfg.tp))
        del out
    tokens = torch.empty(B, max_new_tokens, dtype=torch.long, device=device)
    tokens[:, 0] = next_token(_gathered(logits, device))
    if mark is not None:
        mark("prefill")
    done = None
    if eos_token_id is not None:
        done = torch.isin(tokens[:, 0], eos_token_id)
    i = 1
    while i < max_new_tokens:
        if done is not None and (i - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        pos = (lengths + i - 1)[:, None] if full_mask is not None else None
        logits = []
        for sh in shards:
            out = llama_forward(
                sh.params, cfg, sh.rows(tokens[:, i - 1:i]), attention_mask=sh.rows(full_mask),
                position_ids=sh.rows(pos), cache=sh.cache,
                interventions=None if intervene_prefill_only else sh.interventions,
            )
            sh.cache = out["cache"]
            logits.append(out["logits"][:, -1])
        nxt = next_token(_gathered(logits, device))
        if done is not None:
            nxt = torch.where(done, eos_token_id[0], nxt)
            done |= torch.isin(nxt, eos_token_id)
        tokens[:, i] = nxt
        if mark is not None:
            mark("step")
        i += 1
    if done is not None:
        tokens[:, i:] = eos_token_id[0]
    return torch.cat([ids, tokens], dim=1)


class _GenerateShard:
    """One replica's rows [start, end) of a generate batch: its parameters,
    its KV cache on its device, and its interventions (the whole batch's,
    narrowed to its rows, when the batch is split)."""

    def __init__(self, params, cfg, start, end, home, max_len, interventions, split):
        self.params, self.start, self.end = params, start, end
        self.device = leaf_device(params["embed_tokens"])
        self.cache = KVCache.init(cfg, end - start, max_len, dtype=leaf_dtype(params["embed_tokens"]),
                                  device=self.device)
        self.split = split
        self.interventions = interventions
        if split and interventions:
            from ..parallel.data_parallel import rows_intervention

            self.interventions = {k: rows_intervention(fn, start, end, home) for k, fn in interventions.items()}

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None or not self.split:
            return x
        return x[self.start:self.end].to(self.device)


def _gathered(parts: List[torch.Tensor], device) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat([p.to(device) for p in parts])


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering with HF `TopPLogitsWarper` semantics
    (multimodal_sae_tpu/models/llama.py `top_p_filter`): sort ascending
    (stable, so ties keep index order), remove the tokens whose bottom-up
    cumulative mass is <= 1 - top_p (always keeping the top one), and
    scatter the mask back through the permutation.  A tie class at the
    boundary keeps its higher-index members, as HF does.  `1 - top_p` is
    taken in fp32, as the JAX side computes it."""
    sorted_logits, order = torch.sort(logits, dim=-1, stable=True)
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    remove_sorted = cum <= 1.0 - torch.tensor(top_p, dtype=torch.float32, device=logits.device)
    remove_sorted[..., -1] = False
    remove = remove_sorted.scatter(-1, order, remove_sorted)
    return logits.masked_fill(remove, float("-inf"))


def _make_next_token_fn(
    do_sample: bool, temperature: float, top_p: Optional[float], generator: Optional[torch.Generator]
) -> Callable[[torch.Tensor], torch.Tensor]:
    """(logits (B, V)) -> next token ids (B,): the argmax, or a draw from
    the fp32 logits / temperature after `top_p_filter` (HF warps in fp32
    whatever the model's dtype)."""

    def next_token(logits: torch.Tensor) -> torch.Tensor:
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        logits = logits.float() / float(temperature)
        if top_p is not None and top_p < 1.0:
            logits = top_p_filter(logits, top_p)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]

    return next_token
