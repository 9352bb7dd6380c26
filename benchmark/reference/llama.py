"""Plain float32 decoder of the Mistral / Llama family: RMSNorm, rotary
positions (half-split), grouped-query causal attention over right-padded
rows, SwiGLU MLP, no biases.  Written from the published architecture; it
shares no code with the port.  Weights come from `benchmark/weights.py`,
drawn again from the seed, one layer at a time."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import weights
from .lowp import Precision


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, S, hd) rotated by the position angles, halves paired."""
    hd = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = (positions.double()[:, None] * inv_freq[None, :]).float()
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, valid: torch.Tensor, prec: Precision) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, kvH, S, hd); a query attends to the keys
    at or before it that are valid (`valid` (B, S) bool)."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = prec.mm(q, k.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None, None] & valid[:, None, None, :]
    scores = scores.masked_fill(~allowed, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return prec.mm(probs, v)


def decoder_layer(h: torch.Tensor, w: dict, text: dict, valid: torch.Tensor, prec: Precision) -> torch.Tensor:
    B, S, D = h.shape
    H, kvH = text["num_attention_heads"], text["num_key_value_heads"]
    hd = text.get("head_dim") or D // H
    eps = text["rms_norm_eps"]
    pos = torch.arange(S, device=h.device)
    x = rms_norm(h, w["input_layernorm"], eps)
    q = prec.linear(x, w["q_proj"]).view(B, S, H, hd).transpose(1, 2)
    k = prec.linear(x, w["k_proj"]).view(B, S, kvH, hd).transpose(1, 2)
    v = prec.linear(x, w["v_proj"]).view(B, S, kvH, hd).transpose(1, 2)
    q, k = rotary(q, pos, text["rope_theta"]), rotary(k, pos, text["rope_theta"])
    a = attention(q, k, v, valid, prec).transpose(1, 2).reshape(B, S, H * hd)
    h = h + prec.linear(a, w["o_proj"])
    x = rms_norm(h, w["post_attention_layernorm"], eps)
    gate, up = prec.linear(x, w["gate_proj"]), prec.linear(x, w["up_proj"])
    return h + prec.linear(torch.nn.functional.silu(gate) * up, w["down_proj"])


def valid_mask(lengths: Sequence[int], S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :] < torch.tensor(list(lengths), device=device)[:, None]


def hidden_at(text: dict, seed: int, embeds: torch.Tensor, lengths: Sequence[int], layer: int,
              precisions: List[Precision], device) -> List[torch.Tensor]:
    """The output of decoder layer `layer` for right-padded rows whose
    first-layer inputs are `embeds` (B, S, D) and whose valid lengths are
    `lengths`, once per precision (the weights drawn once a layer)."""
    valid = valid_mask(lengths, embeds.shape[1], device)
    hs = [embeds.float() for _ in precisions]
    for i in range(layer + 1):
        w = weights.llama_layer(text, seed, i, device)
        hs = [decoder_layer(h, w, text, valid, p) for h, p in zip(hs, precisions)]
        del w
    return hs


def embed_ids(text: dict, seed: int, ids: torch.Tensor, device) -> torch.Tensor:
    table = weights.llama_embed(text, seed, device)
    return table[ids.to(device)].float()


def text_hidden(text: dict, seed: int, ids: torch.Tensor, layer: int, precisions: List[Precision], device,
                lengths: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Layer `layer`'s output for token rows `ids` (B, S)."""
    lengths = [ids.shape[1]] * ids.shape[0] if lengths is None else lengths
    return hidden_at(text, seed, embed_ids(text, seed, ids, device), lengths, layer, precisions, device)
