"""Full CLIP: the text tower and both projections on top of the vision tower
of `clip_vit.py` (multimodal_sae_tpu/models/clip_full.py), the backend of
the CLIP-Score metric.

Numerics follow the JAX package, which follows HF `CLIPModel` at fp32: a
causal-masked text encoder with quick_gelu MLPs, pooling at the EOS token
(at the argmax token id for legacy configs whose eos_token_id is 2), the
text and visual projections, and score = max(0, 100 · cos(image, text)).
The JAX package computes all of it with plain `jnp` (no TPU kernel), so the
products stay `torch.matmul` here; they run in fp32 with TF32 off
(`device.set_precision`), as the JAX side runs at fp32.  Weights keep HF's
(out, in) layout, as in `clip_vit.py`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device, set_precision
from .clip_vit import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    ClipVisionConfig,
    clip_attention,
    clip_params_from_state_dict,
    clip_vision_forward,
    init_clip_params,
    layer_norm,
    quick_gelu,
)


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    eos_token_id: int = 49407

    @classmethod
    def from_hf(cls, d: dict) -> "ClipTextConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def clip_text_forward(params: dict, cfg: ClipTextConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """The pooled text embedding (B, D): the final layer norm's output at
    each row's EOS position."""
    ids = torch.as_tensor(input_ids).to(device=params["token_embedding"].device, dtype=torch.long)
    B, S = ids.shape
    h = params["token_embedding"][ids] + params["position_embedding"][None, :S]
    pos = torch.arange(S, device=h.device)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, torch.finfo(torch.float32).min)[None, None]
    for lp in params["layers"]:
        x = layer_norm(h, lp["ln1"], lp["ln1_bias"], cfg.layer_norm_eps)
        h = h + clip_attention(x, lp, cfg.num_attention_heads, mask=causal)
        x = layer_norm(h, lp["ln2"], lp["ln2_bias"], cfg.layer_norm_eps)
        x = quick_gelu(F.linear(x, lp["fc1"]) + lp["fc1_bias"])
        h = h + (F.linear(x, lp["fc2"]) + lp["fc2_bias"])
    h = layer_norm(h, params["final_layer_norm"], params["final_layer_norm_bias"], cfg.layer_norm_eps)
    # HF pooling: legacy configs (eos_token_id == 2) pool at argmax(input_ids)
    # (EOT has the highest id); others at the first eos_token_id.  argmax
    # returns the first maximum, as jnp.argmax does.
    if cfg.eos_token_id == 2:
        pool_pos = ids.argmax(-1)
    else:
        pool_pos = (ids == cfg.eos_token_id).to(torch.int32).argmax(-1)
    return h[torch.arange(B, device=h.device), pool_pos]


def clip_embed_image(params: dict, vision_cfg: ClipVisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) pixels -> (B, projection_dim): the CLS token after every
    layer and the post layer norm, through the visual projection."""
    set_precision()
    vision = params["vision"]
    pv = torch.as_tensor(pixel_values).to(vision["patch_embedding"].device)
    h = clip_vision_forward(vision, vision_cfg, pv, feature_layer=-1)
    pooled = layer_norm(h[:, 0], vision["post_layernorm"], vision["post_layernorm_bias"], vision_cfg.layer_norm_eps)
    return F.linear(pooled, params["visual_projection"])


def clip_embed_text(params: dict, text_cfg: ClipTextConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) token ids -> (B, projection_dim)."""
    set_precision()
    return F.linear(clip_text_forward(params["text"], text_cfg, input_ids), params["text_projection"])


def clip_score(
    params: dict,
    vision_cfg: ClipVisionConfig,
    text_cfg: ClipTextConfig,
    pixel_values: torch.Tensor,
    input_ids: torch.Tensor,
) -> torch.Tensor:
    """torchmetrics CLIPScore semantics: max(0, 100 · cos(img, txt)) per pair."""
    img = clip_embed_image(params, vision_cfg, pixel_values)
    txt = clip_embed_text(params, text_cfg, input_ids)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    return torch.clamp_min(100.0 * (img * txt).sum(-1), 0.0)


_TEXT_LAYER_KEYS = {
    "ln1": "layer_norm1.weight", "ln1_bias": "layer_norm1.bias",
    "q_proj": "self_attn.q_proj.weight", "q_bias": "self_attn.q_proj.bias",
    "k_proj": "self_attn.k_proj.weight", "k_bias": "self_attn.k_proj.bias",
    "v_proj": "self_attn.v_proj.weight", "v_bias": "self_attn.v_proj.bias",
    "out_proj": "self_attn.out_proj.weight", "out_bias": "self_attn.out_proj.bias",
    "ln2": "layer_norm2.weight", "ln2_bias": "layer_norm2.bias",
    "fc1": "mlp.fc1.weight", "fc1_bias": "mlp.fc1.bias",
    "fc2": "mlp.fc2.weight", "fc2_bias": "mlp.fc2.bias",
}


def clip_model_params_from_state_dict(
    sd: Dict[str, torch.Tensor],
    vision_cfg: ClipVisionConfig,
    text_cfg: ClipTextConfig,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """HF CLIPModel keys -> the port's tree: {"vision", "text",
    "visual_projection", "text_projection"}, matrices (out, in)."""

    def get(key):
        return torch.as_tensor(sd[key]).to(device=device, dtype=dtype)

    p = "text_model."
    text = {
        "token_embedding": get(p + "embeddings.token_embedding.weight"),
        "position_embedding": get(p + "embeddings.position_embedding.weight"),
        "final_layer_norm": get(p + "final_layer_norm.weight"),
        "final_layer_norm_bias": get(p + "final_layer_norm.bias"),
        "layers": [
            {name: get(f"{p}encoder.layers.{i}.{key}") for name, key in _TEXT_LAYER_KEYS.items()}
            for i in range(text_cfg.num_hidden_layers)
        ],
    }
    return {
        "vision": clip_params_from_state_dict(sd, vision_cfg, device, dtype=dtype, prefix="vision_model."),
        "text": text,
        "visual_projection": get("visual_projection.weight"),
        "text_projection": get("text_projection.weight"),
    }


def init_clip_model_params(
    vision_cfg: ClipVisionConfig,
    text_cfg: ClipTextConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random weights at the configs' widths for runs without a checkpoint,
    drawn on `device` from `generator` (the vision tower as
    `clip_vit.init_clip_params` draws it; text matrices normal scaled by
    fan-in^-0.5, embeddings by 0.02, norms at 1, biases at 0)."""
    D, I = text_cfg.hidden_size, text_cfg.intermediate_size

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32).mul_(scale).to(dtype)

    def const(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    def layer():
        out = {}
        for name, key in _TEXT_LAYER_KEYS.items():
            if key.endswith("bias"):
                out[name] = const(0.0, I if name == "fc1_bias" else D)
            elif name.startswith("ln"):
                out[name] = const(1.0, D)
            else:
                shape = {"fc1": (I, D), "fc2": (D, I)}.get(name, (D, D))
                out[name] = normal(shape, shape[1] ** -0.5)
        return out

    text = {
        "token_embedding": normal((text_cfg.vocab_size, D), 0.02),
        "position_embedding": normal((text_cfg.max_position_embeddings, D), 0.02),
        "final_layer_norm": const(1.0, D),
        "final_layer_norm_bias": const(0.0, D),
        "layers": [layer() for _ in range(text_cfg.num_hidden_layers)],
    }
    return {
        "vision": init_clip_params(vision_cfg, generator, device, dtype),
        "text": text,
        "visual_projection": normal((vision_cfg.projection_dim, vision_cfg.hidden_size), vision_cfg.hidden_size**-0.5),
        "text_projection": normal((text_cfg.projection_dim, D), D**-0.5),
    }


def preprocess_clip_image(image, image_size: int) -> np.ndarray:
    """CLIPImageProcessor: resize the shortest edge, centre crop, normalise.
    (3, image_size, image_size) float32, bit for bit the JAX package's."""
    from PIL import Image

    image = image.convert("RGB")
    w, h = image.size
    # HF get_resize_output_image_size: shortest edge -> size, the other
    # dimension int-truncated from the exact ratio.
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = image_size, int(image_size * long / short)
    new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
    image = image.resize((new_w, new_h), Image.BICUBIC)
    w, h = image.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(image, dtype=np.float32) / 255.0
    mean = np.asarray(OPENAI_CLIP_MEAN, dtype=np.float32)
    std = np.asarray(OPENAI_CLIP_STD, dtype=np.float32)
    return ((arr - mean) / std).transpose(2, 0, 1)


def clip_metric(model_path: str, device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """A `fn(pil_image, text) -> float` CLIP-Score metric from a local HF
    CLIPModel checkpoint, its weights on `device` (the card unless the
    caller names another): the counterpart of the JAX package's
    `jax_clip_metric`, which ClipScorer takes as `metric=`."""
    dev = resolve_device(device)
    set_precision()
    from transformers import AutoTokenizer

    from .hf_loader import load_hf_config, load_hf_state_dict

    cfg = load_hf_config(model_path)
    vision_cfg = ClipVisionConfig.from_hf(cfg["vision_config"])
    text_cfg = ClipTextConfig.from_hf(cfg["text_config"])
    params = clip_model_params_from_state_dict(load_hf_state_dict(model_path), vision_cfg, text_cfg, dev, dtype)
    tokenizer = AutoTokenizer.from_pretrained(model_path)

    @torch.no_grad()
    def metric(image, text: str) -> float:
        pv = torch.from_numpy(preprocess_clip_image(image, vision_cfg.image_size)[None]).to(dev, dtype)
        ids = tokenizer(
            [text],
            padding="max_length",
            max_length=text_cfg.max_position_embeddings,
            truncation=True,
            return_tensors="np",
        )["input_ids"]
        return float(clip_score(params, vision_cfg, text_cfg, pv, torch.as_tensor(ids, device=dev))[0])

    return metric
