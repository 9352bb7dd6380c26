"""Seeded weights of the benchmark's subjects and SAEs, made on the device.

Each group of tensors (one decoder layer, the embedding table, one CLIP
layer, the SAE's encoder) is one draw from its own `torch.Generator`, seeded
from the run's seed and the group's name, in the dtype the group is served
in; the group's tensors are views of that draw, scaled in place.  So the
reference can draw one group again, alone, and get the same bits.

Matrices are (out, in), scaled by fan-in ** -0.5; norm weights are
1 + 0.05 * N(0, 1) and biases 0.02 * N(0, 1), so that a path that drops a
norm weight or a bias reads differently from one that applies it.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import torch

Spec = Sequence[Tuple[str, Tuple[int, ...], str]]
"""(name, shape, kind): kind "mat" (fan-in scaled), "norm", "bias" or
"embed" (0.02 scaled) or "uniform" (U(-1/sqrt(rows), 1/sqrt(rows)), the
SAE encoder's)."""


def group_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for group `name` of run `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_group(spec: Spec, seed: int, name: str, device, dtype) -> Dict[str, torch.Tensor]:
    """The tensors of one group, views of a single draw."""
    sizes = [_numel(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, name))
    if all(kind == "uniform" for _, _, kind in spec):
        flat = torch.empty(sum(sizes), dtype=dtype, device=device).uniform_(-1.0, 1.0, generator=gen)
    else:
        flat = torch.randn(sum(sizes), dtype=dtype, device=device, generator=gen)
    out, at = {}, 0
    for (key, shape, kind), n in zip(spec, sizes):
        t = flat[at : at + n].view(shape)
        at += n
        if kind == "mat":
            t.mul_(shape[-1] ** -0.5)
        elif kind == "uniform":
            t.mul_(shape[0] ** -0.5)
        elif kind == "norm":
            t.mul_(0.05).add_(1.0)
        elif kind in ("bias", "embed"):
            t.mul_(0.02)
        else:
            raise ValueError(f"unknown init kind {kind!r}")
        out[key] = t
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def llama_layer_spec(text: dict) -> Spec:
    D, I = text["hidden_size"], text["intermediate_size"]
    H, kvH = text["num_attention_heads"], text["num_key_value_heads"]
    hd = text.get("head_dim") or D // H
    return [
        ("input_layernorm", (D,), "norm"),
        ("q_proj", (H * hd, D), "mat"),
        ("k_proj", (kvH * hd, D), "mat"),
        ("v_proj", (kvH * hd, D), "mat"),
        ("o_proj", (D, H * hd), "mat"),
        ("post_attention_layernorm", (D,), "norm"),
        ("gate_proj", (I, D), "mat"),
        ("up_proj", (I, D), "mat"),
        ("down_proj", (D, I), "mat"),
    ]


def llama_layer(text: dict, seed: int, i: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    return draw_group(llama_layer_spec(text), seed, f"text.layer.{i}", device, dtype)


def llama_embed(text: dict, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    spec = [("embed_tokens", (text["vocab_size"], text["hidden_size"]), "embed")]
    return draw_group(spec, seed, "text.embed", device, dtype)["embed_tokens"]


def llama_params(text: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The decoder's tree as the port's `LlamaModel` takes it: the embedding
    and `num_hidden_layers` layers (a capture reads no final norm or LM
    head)."""
    return {
        "embed_tokens": llama_embed(text, seed, device, dtype),
        "layers": [llama_layer(text, seed, i, device, dtype) for i in range(text["num_hidden_layers"])],
    }


def clip_layer_spec(vision: dict) -> Spec:
    D, I = vision["hidden_size"], vision["intermediate_size"]
    return [
        ("ln1", (D,), "norm"), ("ln1_bias", (D,), "bias"),
        ("q_proj", (D, D), "mat"), ("q_bias", (D,), "bias"),
        ("k_proj", (D, D), "mat"), ("k_bias", (D,), "bias"),
        ("v_proj", (D, D), "mat"), ("v_bias", (D,), "bias"),
        ("out_proj", (D, D), "mat"), ("out_bias", (D,), "bias"),
        ("ln2", (D,), "norm"), ("ln2_bias", (D,), "bias"),
        ("fc1", (I, D), "mat"), ("fc1_bias", (I,), "bias"),
        ("fc2", (D, I), "mat"), ("fc2_bias", (D,), "bias"),
    ]


def clip_params(vision: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The CLIP tower's tree as the port's `clip_vision_forward` takes it."""
    D, p = vision["hidden_size"], vision["patch_size"]
    n_pos = (vision["image_size"] // p) ** 2 + 1
    stem = draw_group([
        ("class_embedding", (D,), "embed"),
        ("patch_embedding", (D, 3 * p * p), "mat"),
        ("position_embedding", (n_pos, D), "embed"),
        ("pre_layrnorm", (D,), "norm"), ("pre_layrnorm_bias", (D,), "bias"),
        ("post_layernorm", (D,), "norm"), ("post_layernorm_bias", (D,), "bias"),
    ], seed, "vision.stem", device, dtype)
    stem["layers"] = [draw_group(clip_layer_spec(vision), seed, f"vision.layer.{i}", device, dtype)
                      for i in range(vision["num_hidden_layers"])]
    return stem


def projector_params(vision: dict, text: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    Dv, Dt = vision["hidden_size"], text["hidden_size"]
    return draw_group([
        ("linear_1", (Dt, Dv), "mat"), ("linear_1_bias", (Dt,), "bias"),
        ("linear_2", (Dt, Dt), "mat"), ("linear_2_bias", (Dt,), "bias"),
        ("image_newline", (Dt,), "embed"),
    ], seed, "projector", device, dtype)


def llava_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The LLaVA-NeXT tree as the port's `LlavaNextModel` takes it."""
    proj = projector_params(cfg["vision_config"], cfg["text_config"], seed, device, dtype)
    newline = proj.pop("image_newline")
    return {
        "vision_tower": clip_params(cfg["vision_config"], seed, device, dtype),
        "projector": proj,
        "image_newline": newline,
        "language_model": llama_params(cfg["text_config"], seed, device, dtype),
    }


def sae_params(sae: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The SAE's encoder (d_in, L) U(-1/sqrt(d_in), 1/sqrt(d_in)), as the
    released SAEs are initialised, and its two biases (a cache never
    decodes)."""
    d, L = sae["d_in"], sae["num_latents"]
    out = draw_group([("W_enc", (d, L), "uniform")], seed, "sae.encoder", device, dtype)
    out.update(draw_group([("b_enc", (L,), "bias"), ("b_dec", (d,), "bias")], seed, "sae.biases", device, dtype))
    return out

