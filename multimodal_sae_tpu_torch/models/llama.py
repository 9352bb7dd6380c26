"""LLaMA-3 decoder, capture path (multimodal_sae_tpu/models/llama.py).

`llama_forward` returns the post-layer residual hidden states at the
requested hookpoints ("layers.{i}") and runs no layer above the last one:
the JAX package gets that from XLA's dead-code elimination, PyTorch runs
eagerly, so the loop stops explicitly.  Numerics follow HF `LlamaModel`:
RMSNorm variance and RoPE cos/sin in fp32, softmax in fp32.  Projection
weights keep PyTorch's (out, in) layout (`F.linear`), as HF checkpoints store
them; `convert.py` carries the JAX package's (in, out) matrices across.

With `LlamaConfig.flash_attention` the attention runs through kernel K3
(ops/flash_attention.py) with k and v left at kvH heads; eager attention
repeats them, as HF does.  Generation, interventions, logits and
`forward_from_layer` come with the interventions slice.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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


@torch.no_grad()
def llama_forward(
    params: dict,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    capture: Sequence[str] = (),
) -> Dict[str, torch.Tensor]:
    """Capture forward: {hookpoint: (B, S, D) post-layer residual}.  Runs
    layers 0..(deepest captured layer) and no further."""
    h = params["embed_tokens"][input_ids]
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_dict)
    if cfg.flash_attention and S > 1:
        # Causality and pad-key exclusion happen inside the kernel.
        mask, pad_mask = None, attention_mask
    else:
        mask, pad_mask = causal_mask(S, attention_mask, h.device), None
    cap_by_idx = {hookpoint_layer_idx(c): c for c in capture}
    if not cap_by_idx:
        return {}
    last = max(cap_by_idx)
    if last >= len(params["layers"]):
        raise ValueError(f"hookpoint layer {last} is past the subject's {len(params['layers'])} layers")
    captured = {}
    for i in range(last + 1):
        h = decoder_layer(params["layers"][i], cfg, h, cos, sin, mask, pad_mask)
        if i in cap_by_idx:
            captured[cap_by_idx[i]] = h
    return captured


def init_llama_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random init (normal, scaled by fan-in^-0.5 as the JAX package's
    `init_llama_params`) for runs without a checkpoint, drawn on `device`
    from `generator`.  No LM head: capture never reads it."""
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
    return {
        "embed_tokens": mat((V, D), scale=0.02),
        "layers": layers,
        "norm": torch.ones(D, dtype=dtype, device=device),
    }


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

    def capture(self, batch: dict, hookpoints: List[str]) -> Dict[str, torch.Tensor]:
        ids = torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long)
        amask = batch.get("attention_mask")
        if amask is not None:
            amask = np.asarray(amask)
            # An all-ones mask masks nothing: drop it, as the JAX side does.
            amask = None if amask.all() else torch.as_tensor(amask, device=self.device)
        return llama_forward(
            self.params, self.cfg, ids.to(self.device),
            attention_mask=amask, capture=tuple(hookpoints),
        )
