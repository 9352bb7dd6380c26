"""HF LLaMA checkpoint -> the port's param tree
(multimodal_sae_tpu/models/hf_loader.py), read through the port's own
safetensors reader.  Projection weights keep HF's (out, in) layout."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..utils.safetensors_io import load_file
from .llama import LlamaConfig


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the `*.safetensors` files of a local HF checkpoint."""
    files = sorted(Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(load_file(f))
    return tensors


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def llama_params_from_state_dict(
    sd: Dict[str, torch.Tensor],
    cfg: LlamaConfig,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    prefix: str = "model.",
) -> dict:
    """Map HF LlamaForCausalLM / LlamaModel keys to the port's tree.

    `prefix` is "model." for LlamaForCausalLM, "" for a bare LlamaModel and
    "language_model.model." (or a post-4.52 form) inside LLaVA-NeXT.
    Layers past `cfg.num_hidden_layers` stay off the device.  An untied
    checkpoint's `lm_head.weight` is loaded as `lm_head`; a missing one is
    an error, as in the JAX package: falling back to the embedding would
    make every logit wrong."""

    def get(key):
        return sd[key].to(device=device, dtype=dtype)

    layer_keys = {
        "input_layernorm": "input_layernorm.weight",
        "q_proj": "self_attn.q_proj.weight",
        "k_proj": "self_attn.k_proj.weight",
        "v_proj": "self_attn.v_proj.weight",
        "o_proj": "self_attn.o_proj.weight",
        "post_attention_layernorm": "post_attention_layernorm.weight",
        "gate_proj": "mlp.gate_proj.weight",
        "up_proj": "mlp.up_proj.weight",
        "down_proj": "mlp.down_proj.weight",
    }
    layers = [
        {name: get(f"{prefix}layers.{i}.{key}") for name, key in layer_keys.items()}
        for i in range(cfg.num_hidden_layers)
    ]
    params = {
        "embed_tokens": get(f"{prefix}embed_tokens.weight"),
        "layers": layers,
        "norm": get(f"{prefix}norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        # The head lives beside the decoder: "language_model.lm_head.weight"
        # for the prefix "language_model.model." of a LLaVA checkpoint.
        parts = prefix.rstrip(".").split(".") if prefix else []
        sibling = ".".join(parts[:-1]) + "." if len(parts) > 1 else ""
        candidates = ("lm_head.weight", sibling + "lm_head.weight", f"{prefix}lm_head.weight")
        head = next((key for key in candidates if key in sd), None)
        if head is None:
            raise KeyError(
                "untied checkpoint (tie_word_embeddings=false) but no lm_head.weight; "
                "refusing to fall back to embed_tokens: logits would be wrong"
            )
        params["lm_head"] = get(head)
    return params


def truncated(cfg: LlamaConfig, truncate_layers: int) -> LlamaConfig:
    """`cfg` cut to its first `truncate_layers` layers (0 keeps them all)."""
    if not truncate_layers:
        return cfg
    if truncate_layers > cfg.num_hidden_layers:
        raise ValueError(
            f"--truncate_layers {truncate_layers} exceeds the subject's "
            f"{cfg.num_hidden_layers} layers"
        )
    return dataclasses.replace(cfg, num_hidden_layers=truncate_layers)


def load_llama(
    path: str,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    truncate_layers: int = 0,
) -> Tuple[dict, LlamaConfig]:
    """Local HF LLaMA checkpoint dir -> (params, cfg).  `truncate_layers`
    > 0 keeps only the first N layers, whose weights alone reach the
    device, and sets the config's depth to N."""
    cfg = truncated(LlamaConfig.from_hf(load_hf_config(path)), truncate_layers)
    sd = load_hf_state_dict(path)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    params = llama_params_from_state_dict(sd, cfg, resolve_device(device), dtype, prefix)
    return params, cfg
