"""Plain float32 LLaVA-NeXT image path: the CLIP ViT tower (pre-LN blocks,
quick GELU, full attention) up to `vision_feature_layer`, the CLS token
dropped, the two-layer projector with exact GELU, and the anyres packing
(base tile, then the unpadded tile grid row by row, each row closed by the
newline embedding).  Written from HuggingFace's CLIPVisionModel and
LlavaNextForConditionalGeneration; it shares no code with the port."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import weights
from . import anyres
from .lowp import Precision


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def tower(vision: dict, seed: int, pixels: torch.Tensor, feature_layer: int, prec: Precision, device) -> torch.Tensor:
    """hidden_states[feature_layer] of the tower for (n, 3, S, S) tiles."""
    D, p, heads = vision["hidden_size"], vision["patch_size"], vision["num_attention_heads"]
    eps = vision["layer_norm_eps"]
    stem = weights.draw_group(
        [("class_embedding", (D,), "embed"), ("patch_embedding", (D, 3 * p * p), "mat"),
         ("position_embedding", ((vision["image_size"] // p) ** 2 + 1, D), "embed"),
         ("pre_layrnorm", (D,), "norm"), ("pre_layrnorm_bias", (D,), "bias"),
         ("post_layernorm", (D,), "norm"), ("post_layernorm_bias", (D,), "bias")],
        seed, "vision.stem", device, torch.bfloat16)
    n = pixels.shape[0]
    conv = stem["patch_embedding"].float().view(D, 3, p, p)
    x = pixels.float().to(device)
    if prec.low == "fp8":
        patches = F.unfold(x, p, stride=p).transpose(1, 2)
        emb = prec.linear(patches, conv.reshape(D, -1))
    else:
        emb = F.conv2d(x, conv, stride=p).flatten(2).transpose(1, 2)
    h = torch.cat([stem["class_embedding"].float().expand(n, 1, D), emb], 1) + stem["position_embedding"].float()
    h = layer_norm(h, stem["pre_layrnorm"], stem["pre_layrnorm_bias"], eps)
    depth = feature_layer % (vision["num_hidden_layers"] + 1)
    hd = D // heads
    for i in range(depth):
        w = weights.draw_group(weights.clip_layer_spec(vision), seed, f"vision.layer.{i}", device, torch.bfloat16)
        x = layer_norm(h, w["ln1"], w["ln1_bias"], eps)
        T = x.shape[1]
        q = (prec.linear(x, w["q_proj"]) + w["q_bias"].float()).view(n, T, heads, hd).transpose(1, 2)
        k = (prec.linear(x, w["k_proj"]) + w["k_bias"].float()).view(n, T, heads, hd).transpose(1, 2)
        v = (prec.linear(x, w["v_proj"]) + w["v_bias"].float()).view(n, T, heads, hd).transpose(1, 2)
        probs = torch.softmax(prec.mm(q * hd ** -0.5, k.transpose(-1, -2)), -1)
        a = prec.mm(probs, v).transpose(1, 2).reshape(n, T, D)
        h = h + prec.linear(a, w["out_proj"]) + w["out_bias"].float()
        x = layer_norm(h, w["ln2"], w["ln2_bias"], eps)
        x = prec.linear(x, w["fc1"]) + w["fc1_bias"].float()
        x = x * torch.sigmoid(1.702 * x)
        h = h + prec.linear(x, w["fc2"]) + w["fc2_bias"].float()
    return h


def image_features(cfg: dict, seed: int, pixels: torch.Tensor, hw, prec: Precision, device) -> torch.Tensor:
    """(n_features, D_text) packed features of one image."""
    vision, text = cfg["vision_config"], cfg["text_config"]
    feats = tower(vision, seed, pixels, cfg["vision_feature_layer"], prec, device)[:, 1:]
    proj = weights.projector_params(vision, text, seed, device)
    x = prec.linear(feats, proj["linear_1"]) + proj["linear_1_bias"].float()
    x = F.gelu(x)
    x = prec.linear(x, proj["linear_2"]) + proj["linear_2_bias"].float()
    tile, patch = vision["image_size"], vision["patch_size"]
    side = tile // patch
    ph, pw = anyres.best_resolution(hw, cfg["image_grid_pinpoints"])
    gh, gw = ph // tile, pw // tile
    Dt = x.shape[-1]
    grid = x[1 : 1 + gh * gw].view(gh, gw, side, side, Dt).permute(0, 2, 1, 3, 4).reshape(gh * side, gw * side, Dt)
    rows, cols, pad = anyres.unpadded(hw, gh * side, gw * side)
    if rows != gh * side:
        grid = grid[pad : pad + rows]
    elif cols != gw * side:
        grid = grid[:, pad : pad + cols]
    newline = proj["image_newline"].float().expand(rows, 1, Dt)
    grid = torch.cat([grid, newline], 1).reshape(rows * (cols + 1), Dt)
    return torch.cat([x[0], grid], 0)
