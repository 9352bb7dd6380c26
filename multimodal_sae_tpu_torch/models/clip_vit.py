"""CLIP ViT vision tower, the LLaVA-NeXT image encoder
(multimodal_sae_tpu/models/clip_vit.py).

Numerics follow the JAX package op for op, in its dtype order: pixels cast
to the tower's dtype before the patch product; layer norm with mean and
variance taken in fp32 and rounded to the tower's dtype, the rest in that
dtype; attention scores as fp32 products of the tower-dtype q and k, the
softmax in fp32, its probabilities cast back before the P·V product.  The
attention is no TPU kernel in the JAX package (plain jnp), so it stays
`torch.matmul` here.  Projection weights keep PyTorch's (out, in) layout
(`F.linear`), as HF checkpoints store them; `convert.py` carries the JAX
package's (in, out) matrices across.  `hidden_states` indexing follows HF:
index 0 is the embedding output, index i + 1 is encoder layer i's output.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .quant import leaf_dtype, qmatmul

# OpenAI CLIP pixel normalisation (HF CLIPImageProcessor defaults).
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

@dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    """MLP activation from the checkpoint config; anything but quick_gelu,
    gelu, gelu_new and gelu_pytorch_tanh raises in `_activation`."""

    int8_matmul: bool = False
    """Run a quantised tower's matrices through the W8A8 product
    (models/quant.py `qmatmul(int8=True)`); ignored for dense weights,
    which a quantised tower otherwise runs as W8A16."""

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf(cls, d: dict) -> "ClipVisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def as_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: a Python constant meets a JAX array of a
    narrower dtype as a weak type, rounded to the array's dtype first (1.702
    becomes 1.703125 in bf16).  PyTorch would use it unrounded."""
    return float(torch.tensor(value, dtype=dtype))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX package's layer norm: jnp.mean and jnp.var compute in fp32 and
    round to x's dtype; the normalisation and affine run in x's dtype."""
    x32 = x.float()
    mean32 = x32.mean(-1, keepdim=True)
    var = (x32 - mean32).square().mean(-1, keepdim=True).to(x.dtype)
    return (x - mean32.to(x.dtype)) * torch.rsqrt(var + as_dtype(eps, x.dtype)) * weight + bias


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(as_dtype(1.702, x.dtype) * x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """`jax.nn.gelu`, op for op: the exact form through erfc, or the tanh
    approximation, constants in x's dtype."""
    if approximate:
        inner = as_dtype(math.sqrt(2 / math.pi), x.dtype) * (x + as_dtype(0.044715, x.dtype) * x**3)
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    return 0.5 * x * torch.erfc(-x * as_dtype(math.sqrt(0.5), x.dtype))


def _activation(name: str):
    """hidden_act -> callable ('gelu' is the exact erf GELU, as in HF)."""
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return gelu
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: gelu(x, approximate=True)
    raise NotImplementedError(
        f"hidden_act {name!r} is not implemented; activations would be "
        "silently wrong with a substitute"
    )


def _patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, (H/p)*(W/p), 3*p*p), (channel, ph, pw) order as
    the conv weight's (out, in, kh, kw)."""
    B, C, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, gh, gw, C, ph, pw)
    return x.reshape(B, gh * gw, C * patch * patch)


def clip_attention(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], num_heads: int, mask: Optional[torch.Tensor] = None,
    int8: bool = False,
) -> torch.Tensor:
    """Self-attention of one CLIP layer; `mask`, when given, is added to the
    fp32 scores (the text tower's causal mask).  Quantised projections run
    through `qmatmul` (W8A8 with `int8`)."""
    B, S, D = x.shape
    hd = D // num_heads
    q = qmatmul(x, lp["q_proj"], int8=int8) + lp["q_bias"]
    k = qmatmul(x, lp["k_proj"], int8=int8) + lp["k_bias"]
    v = qmatmul(x, lp["v_proj"], int8=int8) + lp["v_bias"]
    q = q.view(B, S, num_heads, hd).transpose(1, 2) * as_dtype(hd**-0.5, x.dtype)
    k = k.view(B, S, num_heads, hd).transpose(1, 2)
    v = v.view(B, S, num_heads, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, D)
    return qmatmul(out, lp["out_proj"], int8=int8) + lp["out_bias"]


def clip_vision_forward(
    params: dict,
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,
    *,
    feature_layer: int = -2,
) -> torch.Tensor:
    """hidden_states[feature_layer] (B, 1+P, D), indexed as HF's
    `hidden_states` (0 is the pre-layernormed embeddings).  No layer above
    the feature layer runs: the JAX package's "last" output (the
    post-layernormed final hidden) has no caller in this package.  A
    quantised tower (models/quant.py `quantize_clip_params`) computes in
    bf16, its products W8A16, or W8A8 with `cfg.int8_matmul`."""
    idx = feature_layer % (len(params["layers"]) + 1)
    i8 = cfg.int8_matmul
    dtype = leaf_dtype(params["patch_embedding"])
    B = pixel_values.shape[0]

    patches = _patchify(pixel_values.to(dtype), cfg.patch_size)
    patch_embeds = qmatmul(patches, params["patch_embedding"], int8=i8)  # (B, P, D)
    cls = params["class_embedding"][None, None, :].expand(B, 1, cfg.hidden_size)
    h = torch.cat([cls, patch_embeds], dim=1) + params["position_embedding"][None]
    h = layer_norm(h, params["pre_layrnorm"], params["pre_layrnorm_bias"], cfg.layer_norm_eps)

    act = _activation(cfg.hidden_act)
    for lp in params["layers"][:idx]:
        x = layer_norm(h, lp["ln1"], lp["ln1_bias"], cfg.layer_norm_eps)
        h = h + clip_attention(x, lp, cfg.num_attention_heads, int8=i8)
        x = layer_norm(h, lp["ln2"], lp["ln2_bias"], cfg.layer_norm_eps)
        x = act(qmatmul(x, lp["fc1"], int8=i8) + lp["fc1_bias"])
        h = h + (qmatmul(x, lp["fc2"], int8=i8) + lp["fc2_bias"])
    return h


def clip_params_from_state_dict(
    sd: Dict[str, torch.Tensor],
    cfg: ClipVisionConfig,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    prefix: str = "vision_model.",
) -> dict:
    """HF CLIPVisionModel keys -> the port's tree; matrices stay (out, in),
    the patch conv (D, 3, p, p) becomes (D, 3*p*p)."""

    def get(key):
        return sd[prefix + key].to(device=device, dtype=dtype)

    conv = get("embeddings.patch_embedding.weight")
    layer_keys = {
        "ln1": "layer_norm1.weight", "ln1_bias": "layer_norm1.bias",
        "q_proj": "self_attn.q_proj.weight", "q_bias": "self_attn.q_proj.bias",
        "k_proj": "self_attn.k_proj.weight", "k_bias": "self_attn.k_proj.bias",
        "v_proj": "self_attn.v_proj.weight", "v_bias": "self_attn.v_proj.bias",
        "out_proj": "self_attn.out_proj.weight", "out_bias": "self_attn.out_proj.bias",
        "ln2": "layer_norm2.weight", "ln2_bias": "layer_norm2.bias",
        "fc1": "mlp.fc1.weight", "fc1_bias": "mlp.fc1.bias",
        "fc2": "mlp.fc2.weight", "fc2_bias": "mlp.fc2.bias",
    }
    return {
        "class_embedding": get("embeddings.class_embedding"),
        "patch_embedding": conv.reshape(conv.shape[0], -1).contiguous(),
        "position_embedding": get("embeddings.position_embedding.weight"),
        "pre_layrnorm": get("pre_layrnorm.weight"),
        "pre_layrnorm_bias": get("pre_layrnorm.bias"),
        "post_layernorm": get("post_layernorm.weight"),
        "post_layernorm_bias": get("post_layernorm.bias"),
        "layers": [
            {name: get(f"encoder.layers.{i}.{key}") for name, key in layer_keys.items()}
            for i in range(cfg.num_hidden_layers)
        ],
    }


def init_clip_params(
    cfg: ClipVisionConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random weights at `cfg`'s widths for runs without a checkpoint:
    matrices normal scaled by fan-in^-0.5, embeddings by 0.02, norms at 1
    and biases at 0, drawn on `device` from `generator`."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    n_pos = cfg.num_patches + 1

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    def mat(out_dim, in_dim):
        return normal((out_dim, in_dim), in_dim**-0.5)

    def const(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    layers = [
        {
            "ln1": const(1.0, D), "ln1_bias": const(0.0, D),
            "q_proj": mat(D, D), "q_bias": const(0.0, D),
            "k_proj": mat(D, D), "k_bias": const(0.0, D),
            "v_proj": mat(D, D), "v_bias": const(0.0, D),
            "out_proj": mat(D, D), "out_bias": const(0.0, D),
            "ln2": const(1.0, D), "ln2_bias": const(0.0, D),
            "fc1": mat(I, D), "fc1_bias": const(0.0, I),
            "fc2": mat(D, I), "fc2_bias": const(0.0, D),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    return {
        "class_embedding": normal((D,), 0.02),
        "patch_embedding": mat(D, 3 * cfg.patch_size**2),
        "position_embedding": normal((n_pos, D), 0.02),
        "pre_layrnorm": const(1.0, D), "pre_layrnorm_bias": const(0.0, D),
        "post_layernorm": const(1.0, D), "post_layernorm_bias": const(0.0, D),
        "layers": layers,
    }
