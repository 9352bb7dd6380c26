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
(ops/flash_attention.py, forward and backward) with k and v left at kvH
heads; eager attention repeats them, as HF does.  The KV cache, generation
and remat come with the steering slice.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops import flash_attention as fa


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

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

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


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, kvH, S, hd) -> (B, H, S, hd) by repeating each kv head."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=1)


def causal_mask(
    S: int, attention_mask: Optional[torch.Tensor], device: torch.device
) -> torch.Tensor:
    """Additive fp32 mask (B or 1, 1, S, S): causal plus optional padding."""
    neg = torch.finfo(torch.float32).min
    causal = torch.ones(S, S, dtype=torch.bool, device=device).tril()
    mask = torch.where(causal, 0.0, neg)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask[:, None, None, :].bool(), 0.0, neg)
        mask = mask + pad
    return mask


def attention(q, k, v, mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Eager (B, H, S, hd) attention: fp32 scores and softmax (HF eager)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def decoder_layer(
    p: Dict[str, torch.Tensor],
    cfg: LlamaConfig,
    h: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    pad_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    B, S, _ = h.shape
    H, kvH, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    x = rms_norm(h, p["input_layernorm"], cfg.rms_norm_eps)
    q = F.linear(x, p["q_proj"]).view(B, S, H, hd).transpose(1, 2)
    k = F.linear(x, p["k_proj"]).view(B, S, kvH, hd).transpose(1, 2)
    v = F.linear(x, p["v_proj"]).view(B, S, kvH, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    if cfg.flash_attention and S > 1:
        attn = fa.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), pad_mask, scale=hd**-0.5
        )
    else:
        attn = attention(q, _repeat_kv(k, H // kvH), _repeat_kv(v, H // kvH), mask, hd**-0.5)
    h = h + F.linear(attn.transpose(1, 2).reshape(B, S, H * hd), p["o_proj"])
    x = rms_norm(h, p["post_attention_layernorm"], cfg.rms_norm_eps)
    mlp = F.silu(F.linear(x, p["gate_proj"])) * F.linear(x, p["up_proj"])
    return h + F.linear(mlp, p["down_proj"])


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
    capture: Sequence[str] = (),
    interventions: Optional[Dict[str, InterventionFn]] = None,
    return_logits: bool = True,
    return_hidden: bool = False,
    start_layer: int = 0,
) -> dict:
    """Full forward: {"captured": {hookpoint: (B, S, D) post-layer residual},
    "hidden": final post-norm states (with `return_hidden`), "logits"
    (with `return_logits`)}.

    `interventions` {hookpoint: fn} replace layer i's output h by fn(h),
    keyed by layer index (either hookpoint spelling), before it is captured.
    `start_layer > 0` resumes mid-stack: `inputs_embeds` is then the hidden
    state entering layer `start_layer`, and only layers [start_layer,
    num_hidden_layers) run; this is the suffix of attribution patching.
    Without logits or hidden, the loop stops after the deepest hookpoint."""
    if start_layer and inputs_embeds is None:
        raise ValueError("start_layer needs inputs_embeds (the state entering that layer)")
    h = params["embed_tokens"][input_ids] if inputs_embeds is None else inputs_embeds
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_dict)
    if cfg.flash_attention and S > 1:
        # Causality and pad-key exclusion happen inside the kernel.
        mask, pad_mask = None, attention_mask
    else:
        mask, pad_mask = causal_mask(S, attention_mask, h.device), None
    iv_by_idx = {hookpoint_layer_idx(k): fn for k, fn in (interventions or {}).items()}
    cap_by_idx = {hookpoint_layer_idx(c): c for c in capture}
    end = cfg.num_hidden_layers
    if not (return_logits or return_hidden):
        end = max(cap_by_idx, default=start_layer - 1) + 1
    if end > len(params["layers"]):
        raise ValueError(f"layer {end - 1} is past the subject's {len(params['layers'])} layers")
    captured = {}
    for i in range(start_layer, end):
        h = decoder_layer(params["layers"][i], cfg, h, cos, sin, mask, pad_mask)
        if i in iv_by_idx:
            h = iv_by_idx[i](h)
        if i in cap_by_idx:
            captured[cap_by_idx[i]] = h
    out = {"captured": captured}
    if return_logits or return_hidden:
        h_final = rms_norm(h, params["norm"], cfg.rms_norm_eps)
        if return_hidden:
            out["hidden"] = h_final
        if return_logits:
            out["logits"] = lm_head_logits(params, h_final)
    return out


def lm_head_logits(params: dict, h_final: torch.Tensor) -> torch.Tensor:
    """Post-norm hidden states -> vocabulary logits, through `lm_head`
    (V, D) or, for a tied head, the embedding table."""
    head = params.get("lm_head")
    return F.linear(h_final, params["embed_tokens"] if head is None else head)


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
    return lm_head_logits(params, h)


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
    (models/api.py) over a param tree on one device."""

    def __init__(self, params: dict, cfg: LlamaConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["embed_tokens"].device

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
        ids, amask = self._ids_and_mask(batch)
        return llama_forward(
            self.params, self.cfg, ids, attention_mask=amask, capture=tuple(hookpoints),
            return_logits=False,
        )["captured"]

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
