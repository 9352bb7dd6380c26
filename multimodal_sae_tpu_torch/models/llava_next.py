"""LLaVA-NeXT (anyres) subject (multimodal_sae_tpu/models/llava_next.py):
CLIP tower, multimodal projector, anyres tile packing and the LLaMA decoder
with capture.

The anyres geometry (best pinpoint, tile grid, unpadded token grid, token
count) is host arithmetic on the original image size.  `prepare_inputs`
expands each `<image>` placeholder to the image's token count and
right-pads the rows; `_embed_multimodal` runs the tower, projector and
pack once per distinct image, one batched call per geometry, and scatters
the packed features over the placeholder positions.  The JAX package's
XLA mechanisms are left out (its LRU cache of compiled programs, the
forward's 128-token bucket padding, `batch_sharding`); the outputs are the
same.  Generation comes with the steering slice.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .clip_vit import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    ClipVisionConfig,
    clip_params_from_state_dict,
    clip_vision_forward,
    gelu,
    init_clip_params,
)
from .llama import InterventionFn, LlamaConfig, batch_mask, init_llama_params, llama_forward, pad_text_rows

DEFAULT_PINPOINTS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]


@dataclass(frozen=True)
class LlavaNextConfig:
    text_config: LlamaConfig = field(default_factory=LlamaConfig)
    vision_config: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    image_grid_pinpoints: Tuple = tuple(map(tuple, DEFAULT_PINPOINTS))
    image_token_index: int = 128256
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"

    @classmethod
    def from_hf(cls, d: dict) -> "LlavaNextConfig":
        return cls(
            text_config=LlamaConfig.from_hf(d.get("text_config", {})),
            vision_config=ClipVisionConfig.from_hf(d.get("vision_config", {})),
            image_grid_pinpoints=tuple(map(tuple, d.get("image_grid_pinpoints", DEFAULT_PINPOINTS))),
            image_token_index=d.get("image_token_index", 128256),
            vision_feature_layer=d.get("vision_feature_layer", -2),
            vision_feature_select_strategy=d.get("vision_feature_select_strategy", "default"),
        )


# ---- anyres geometry (host arithmetic; HF modeling_llava_next.py and
# processing_llava_next.py semantics) --------------------------------------


def select_best_resolution(original_size: Tuple[int, int], possible_resolutions) -> Tuple[int, int]:
    """The pinpoint (height, width) with the largest effective resolution,
    then the least waste.  `original_size` is (height, width)."""
    original_height, original_width = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for height, width in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        dw, dh = int(original_width * scale), int(original_height * scale)
        effective = min(dw * dh, original_width * original_height)
        wasted = width * height - effective
        if effective > max_effective or (effective == max_effective and wasted < min_wasted):
            max_effective, min_wasted = effective, wasted
            best_fit = (height, width)
    return best_fit


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size: int) -> Tuple[int, int]:
    """(num_patch_height, num_patch_width) of the tile grid."""
    height, width = select_best_resolution(tuple(image_size), grid_pinpoints)
    return height // patch_size, width // patch_size


def image_size_to_num_patches(image_size, grid_pinpoints, patch_size: int) -> int:
    """Tiles of the best pinpoint plus the base tile."""
    h, w = select_best_resolution(tuple(image_size), grid_pinpoints)
    return math.ceil(h / patch_size) * math.ceil(w / patch_size) + 1


def _unpadded_hw(orig_h: int, orig_w: int, grid_h_tokens: int, grid_w_tokens: int) -> Tuple[int, int, int]:
    """Token grid (H, W) after unpadding, and the padding removed per side,
    with HF `unpad_image`'s rounding."""
    current_height, current_width = grid_h_tokens, grid_w_tokens
    original_aspect = orig_w / orig_h
    current_aspect = current_width / current_height
    if original_aspect > current_aspect:
        new_height = int(round(orig_h * (current_width / orig_w), 7))
        padding = (current_height - new_height) // 2
        return current_height - 2 * padding, current_width, padding
    new_width = int(round(orig_w * (current_height / orig_h), 7))
    padding = (current_width - new_width) // 2
    return current_height, current_width - 2 * padding, padding


def get_number_of_features(orig_h: int, orig_w: int, cfg: LlavaNextConfig) -> int:
    """Image tokens after packing (the processor's `_get_number_of_features`,
    which expands the `<image>` placeholder): the unpadded grid, a newline
    per grid row and the base tile, less the CLS under "default"."""
    vis = cfg.vision_config
    height = width = vis.image_size
    best_h, best_w = select_best_resolution((orig_h, orig_w), cfg.image_grid_pinpoints)
    scale_h, scale_w = best_h // height, best_w // width
    patches_h = height // vis.patch_size
    patches_w = width // vis.patch_size
    cur_h, cur_w, _ = _unpadded_hw(orig_h, orig_w, patches_h * scale_h, patches_w * scale_w)
    n = cur_h * cur_w + cur_h + patches_h * patches_w + 1
    if cfg.vision_feature_select_strategy == "default":
        n -= 1
    return n


def preprocess_anyres(image, cfg: LlavaNextConfig) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL image -> (num_patches, 3, S, S) float32 pixel values and its
    (height, width): the resized base tile, then the best pinpoint's tiles
    (aspect-preserving bicubic resize, centre pad, row-major split),
    rescaled by 1/255 and normalised with CLIP's mean and std.  PIL is
    imported here only: the card's path takes prepared arrays."""
    from PIL import Image

    S = cfg.vision_config.image_size
    image = image.convert("RGB")
    orig_w, orig_h = image.size
    best_h, best_w = select_best_resolution((orig_h, orig_w), cfg.image_grid_pinpoints)

    scale = min(best_w / orig_w, best_h / orig_h)
    new_w = min(math.ceil(orig_w * scale), best_w)
    new_h = min(math.ceil(orig_h * scale), best_h)
    arr = np.asarray(image.resize((new_w, new_h), Image.BICUBIC))
    pad_y, r_y = divmod(best_h - new_h, 2)
    pad_x, r_x = divmod(best_w - new_w, 2)
    padded = np.pad(arr, ((pad_y, pad_y + r_y), (pad_x, pad_x + r_x), (0, 0)), mode="constant")

    tiles = [padded[i : i + S, j : j + S] for i in range(0, best_h, S) for j in range(0, best_w, S)]
    patches = [np.asarray(image.resize((S, S), Image.BICUBIC))] + tiles
    mean = np.asarray(OPENAI_CLIP_MEAN, dtype=np.float32)
    std = np.asarray(OPENAI_CLIP_STD, dtype=np.float32)
    out = np.stack([((p.astype(np.float32) / 255.0) - mean) / std for p in patches]).transpose(0, 3, 1, 2)
    return out, (orig_h, orig_w)


# ---- device side ----------------------------------------------------------


def _pack_group(
    projected: torch.Tensor, image_newline: torch.Tensor, cfg: LlavaNextConfig, image_size: Tuple[int, int]
) -> torch.Tensor:
    """`pack_image_features` over G images of one geometry:
    (G, num_patches, tokens_per_tile, D) -> (G, num_image_tokens, D)."""
    vis = cfg.vision_config
    h = w = vis.image_size // vis.patch_size
    orig_h, orig_w = int(image_size[0]), int(image_size[1])
    G, D = projected.shape[0], projected.shape[-1]
    base = projected[:, 0]  # (G, h*w, D)
    if projected.shape[1] == 1:
        return torch.cat([base, image_newline.expand(G, 1, D)], dim=1)

    nph, npw = get_anyres_image_grid_shape((orig_h, orig_w), cfg.image_grid_pinpoints, vis.image_size)
    f = projected[:, 1 : 1 + nph * npw].reshape(G, nph, npw, h, w, D)
    f = f.permute(0, 5, 1, 3, 2, 4).reshape(G, D, nph * h, npw * w)  # (G, D, rows, cols)
    cur_h, cur_w, pad = _unpadded_hw(orig_h, orig_w, nph * h, npw * w)
    if cur_h != nph * h:  # padding along the height
        f = f[:, :, pad : nph * h - pad, :]
    elif cur_w != npw * w:
        f = f[:, :, :, pad : npw * w - pad]
    newline = image_newline[None, :, None, None].expand(G, D, cur_h, 1)
    f = torch.cat([f, newline], dim=3)  # (G, D, cur_h, cur_w + 1)
    f = f.reshape(G, D, cur_h * (cur_w + 1)).transpose(1, 2)
    return torch.cat([base, f], dim=1)


def pack_image_features(
    projected: torch.Tensor, image_newline: torch.Tensor, cfg: LlavaNextConfig, image_size: Tuple[int, int]
) -> torch.Tensor:
    """(num_patches, tokens_per_tile, D) -> (num_image_tokens, D): the
    spatial-unpad packing (HF `pack_image_features`): the base tile's
    tokens, then the unpadded tile grid row by row, each row closed by
    `image_newline`.  `image_size` (height, width) sets the shape."""
    return _pack_group(projected[None], image_newline, cfg, image_size)[0]


def project_image_features(params: dict, cfg: LlavaNextConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """Tower -> feature layer -> drop CLS ("default") -> linear, exact GELU,
    linear.  (num_patches, 3, S, S) -> (num_patches, h*w, D_text)."""
    feats = clip_vision_forward(
        params["vision_tower"], cfg.vision_config, pixel_values, feature_layer=cfg.vision_feature_layer
    )
    if cfg.vision_feature_select_strategy == "default":
        feats = feats[:, 1:]
    p = params["projector"]
    x = F.linear(feats, p["linear_1"]) + p["linear_1_bias"]
    x = gelu(x)
    return F.linear(x, p["linear_2"]) + p["linear_2_bias"]


class LlavaNextModel:
    """ActivationSource and forward for LLaVA-NeXT on one device.

    params = {"vision_tower": clip tree, "projector": {...},
    "image_newline": (D,), "language_model": llama tree}.  Hookpoints are
    "model.layers.{i}", the reference's names on `llava.language_model`;
    "layers.{i}" is accepted too, and captures come back under the
    caller's spelling."""

    HOOK_PREFIX = "model."

    def __init__(self, params: dict, cfg: LlavaNextConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["language_model"]["embed_tokens"].device

    @classmethod
    def random(
        cls,
        cfg: LlavaNextConfig,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
    ) -> "LlavaNextModel":
        """Random weights at `cfg`'s widths, from a seeded torch.Generator."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        D_vis, D_txt = cfg.vision_config.hidden_size, cfg.text_config.hidden_size
        w = lambda o, i: (torch.randn((o, i), generator=gen, device=dev) * i**-0.5).to(dtype)  # noqa: E731
        params = {
            "language_model": init_llama_params(cfg.text_config, gen, dev, dtype),
            "vision_tower": init_clip_params(cfg.vision_config, gen, dev, dtype),
            "projector": {
                "linear_1": w(D_txt, D_vis), "linear_1_bias": torch.zeros(D_txt, dtype=dtype, device=dev),
                "linear_2": w(D_txt, D_txt), "linear_2_bias": torch.zeros(D_txt, dtype=dtype, device=dev),
            },
            "image_newline": (torch.randn(D_txt, generator=gen, device=dev) * D_txt**-0.5).to(dtype),
        }
        return cls(params, cfg)

    # ---- ActivationSource -------------------------------------------------
    def hookpoint_names(self) -> List[str]:
        return [f"{self.HOOK_PREFIX}layers.{i}" for i in range(self.cfg.text_config.num_hidden_layers)]

    def layers_name(self) -> str:
        return f"{self.HOOK_PREFIX}layers"

    def resolve_widths(self, hookpoints: List[str]) -> Dict[str, int]:
        return {h: self.cfg.text_config.hidden_size for h in hookpoints}

    def _strip(self, name: str) -> str:
        return name[len(self.HOOK_PREFIX):] if name.startswith(self.HOOK_PREFIX) else name

    def prepare_inputs(self, images=None, input_ids=None, prompt_ids=None) -> dict:
        """Host-side packing: preprocess the images, expand each
        `<image>` placeholder of `prompt_ids` (one row per image) to the
        image's token count, right-pad the rows with an attention mask.
        Without images, the rows (`input_ids` or `prompt_ids`) are
        right-padded as text.  Each distinct image object is preprocessed
        once, on a thread pool of `MMSAE_PREP_WORKERS` (default: the CPU
        count) when there are several."""
        if images is None:
            return pad_text_rows(input_ids if input_ids is not None else prompt_ids)
        if prompt_ids is not None and len(prompt_ids) != len(images):
            raise ValueError(
                f"prompt_ids rows ({len(prompt_ids)}) != images ({len(images)}): "
                "prepare_inputs pairs one image per row"
            )
        memo = {}
        unique = []
        for im in images:
            if id(im) not in memo:
                memo[id(im)] = None
                unique.append(im)
        n_workers = int(os.environ.get("MMSAE_PREP_WORKERS", os.cpu_count() or 1))
        if len(unique) > 1 and n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(n_workers, len(unique))) as ex:
                results = list(ex.map(lambda im: preprocess_anyres(im, self.cfg), unique))
        else:
            results = [preprocess_anyres(im, self.cfg) for im in unique]
        for im, res in zip(unique, results):
            memo[id(im)] = res

        pixel_list, sizes, expanded = [], [], []
        tok = self.cfg.image_token_index
        for im, row in zip(images, prompt_ids):
            pv, size = memo[id(im)]
            pixel_list.append(pv)
            sizes.append(size)
            count = get_number_of_features(size[0], size[1], self.cfg)
            out = []
            for t in row:
                if t == tok:
                    out.extend([tok] * count)
                else:
                    out.append(t)
            expanded.append(out)
        max_len = max(len(r) for r in expanded)
        ids = np.zeros((len(expanded), max_len), dtype=np.int64)
        amask = np.zeros((len(expanded), max_len), dtype=np.int64)
        for i, r in enumerate(expanded):
            ids[i, : len(r)] = r
            amask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": amask, "pixel_values": pixel_list, "image_sizes": sizes}

    def _project_pack_group(self, pv_stacked: torch.Tensor, size, n_tokens: int) -> torch.Tensor:
        """Tower, projector and pack for G images of one geometry:
        (G, n_patches, 3, S, S) -> (G, n_tokens, D_text)."""
        G, n = pv_stacked.shape[:2]
        projected = project_image_features(self.params, self.cfg, pv_stacked.flatten(0, 1))
        out = _pack_group(projected.view(G, n, *projected.shape[1:]), self.params["image_newline"], self.cfg, size)
        if out.shape[1] != n_tokens:
            raise ValueError(
                f"anyres pack produced {out.shape[1]} features per image, expected {n_tokens} "
                f"(geometry {tuple(size)}): pinpoint/processor mismatch"
            )
        return out

    def _embed_multimodal(self, batch: dict) -> torch.Tensor:
        """Text embeddings with image features scattered over the `<image>`
        positions (HF placeholder mask + masked_scatter).  Distinct images
        are keyed by (id(pixel array), size): rows that share an image
        share its features; one tower+pack call per geometry."""
        embed = self.params["language_model"]["embed_tokens"]
        ids_np = np.asarray(batch["input_ids"])
        ids = torch.as_tensor(ids_np, dtype=torch.long).to(self.device)
        # One list of per-image arrays: iterating a stacked array again would
        # give fresh row objects and defeat the id() memo.
        pv_rows = list(batch["pixel_values"]) if batch.get("pixel_values") is not None else []
        if not pv_rows:
            return embed[ids]
        tok = self.cfg.image_token_index
        vis_size = self.cfg.vision_config.image_size

        distinct = {}  # memo key -> n_tokens
        groups = {}  # (n_patches, size) -> [(memo key, pixels, n_patches)]
        for pv, size in zip(pv_rows, batch["image_sizes"]):
            memo_key = (id(pv), tuple(size))
            if memo_key in distinct:
                continue
            n_patches = image_size_to_num_patches(size, self.cfg.image_grid_pinpoints, vis_size)
            distinct[memo_key] = get_number_of_features(int(size[0]), int(size[1]), self.cfg)
            groups.setdefault((n_patches, tuple(size)), []).append((memo_key, pv, n_patches))

        offsets = {}  # memo key -> first row in flat_feats
        parts = []
        offset = 0
        for (n_patches, size), members in groups.items():
            stacked = torch.stack([torch.as_tensor(pv)[:n_patches] for _, pv, _ in members]).to(self.device)
            n_tokens = distinct[members[0][0]]
            out = self._project_pack_group(stacked, size, n_tokens)
            for i, (memo_key, _, _) in enumerate(members):
                offsets[memo_key] = offset + i * n_tokens
            parts.append(out.reshape(-1, out.shape[-1]))
            offset += out.shape[0] * n_tokens
        flat_feats = parts[0] if len(parts) == 1 else torch.cat(parts)

        rows, cols, fidx = [], [], []
        for b, (pv, size) in enumerate(zip(pv_rows, batch["image_sizes"])):
            memo_key = (id(pv), tuple(size))
            n_tokens = distinct[memo_key]
            positions = np.nonzero(ids_np[b] == tok)[0]
            if len(positions) != n_tokens:
                raise ValueError(
                    f"row {b}: {len(positions)} <image> placeholder tokens != {n_tokens} packed "
                    "features: input_ids were not expanded by prepare_inputs (or geometry mismatch)"
                )
            rows.append(np.full(n_tokens, b, np.int64))
            cols.append(positions)
            fidx.append(offsets[memo_key] + np.arange(n_tokens))
        index = [torch.from_numpy(np.concatenate(a).astype(np.int64)).to(self.device) for a in (rows, cols, fidx)]
        embeds = embed[ids]
        embeds[index[0], index[1]] = flat_feats[index[2]].to(embeds.dtype)
        return embeds

    def forward(
        self,
        batch: dict,
        capture: Sequence[str] = (),
        interventions: Optional[Dict[str, InterventionFn]] = None,
        return_logits: bool = True,
    ) -> dict:
        """Full forward: {"captured": {hookpoint: (B, S, D)} under the
        caller's spelling, "logits" with `return_logits`}."""
        embeds = self._embed_multimodal(batch)
        orig_by_stripped = {self._strip(c): c for c in capture}
        iv = {self._strip(k): v for k, v in interventions.items()} if interventions else None
        out = llama_forward(
            self.params["language_model"], self.cfg.text_config, inputs_embeds=embeds,
            attention_mask=batch_mask(batch, self.device), capture=tuple(sorted(orig_by_stripped)),
            interventions=iv, return_logits=return_logits,
        )
        out["captured"] = {orig_by_stripped[k]: v for k, v in out["captured"].items()}
        return out

    @torch.no_grad()
    def capture(self, batch: dict, hookpoints: List[str]) -> Dict[str, torch.Tensor]:
        batch = self._maybe_prepare(batch)
        return self.forward(batch, capture=hookpoints, return_logits=False)["captured"]

    def _maybe_prepare(self, batch: dict) -> dict:
        """Prepare a raw batch ({"input_ids" with unexpanded placeholders,
        "image"/"images": PIL images}); a prepared one passes through.  The
        rows of a pre-padded raw batch keep only their attended tokens."""
        images = batch.get("images", batch.get("image"))
        if images is None or "pixel_values" in batch:
            return batch
        if not isinstance(images, (list, tuple)):
            images = [images]
        if images[0] is None:
            return {k: v for k, v in batch.items() if k not in ("image", "images")}
        rows = [np.asarray(r).reshape(-1) for r in batch["input_ids"]]
        amask = batch.get("attention_mask")
        if amask is not None:
            am = np.asarray(amask).astype(bool)
            prompt_ids = [list(r[m[: len(r)]]) for r, m in zip(rows, am)]
        else:
            prompt_ids = [list(r) for r in rows]
        return self.prepare_inputs(images=list(images), prompt_ids=prompt_ids)

    def generate(self, batch: dict, *args, **kwargs):
        raise NotImplementedError(
            "LlavaNextModel.generate is not ported yet: ROADMAP.md §1, steering and generation"
        )


def llava_params_from_state_dict(
    sd: Dict[str, torch.Tensor],
    cfg: LlavaNextConfig,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """HF LlavaNextForConditionalGeneration keys, in both the pre- and the
    post-4.52 layout, -> the port's tree.  Language-model layers past
    `cfg.text_config.num_hidden_layers` stay off the device."""
    from .hf_loader import llama_params_from_state_dict

    def find_prefix(cands):
        for c in cands:
            if any(k.startswith(c) for k in sd):
                return c
        raise KeyError(f"none of {cands} found in state dict")

    vis_prefix = find_prefix(["vision_tower.vision_model.", "model.vision_tower.vision_model."])
    lm_prefix = find_prefix(["language_model.model.", "model.language_model.model.", "model.language_model."])
    proj_prefix = find_prefix(["multi_modal_projector.", "model.multi_modal_projector."])
    newline_key = find_prefix(["image_newline", "model.image_newline"])

    def get(key):
        return sd[key].to(device=device, dtype=dtype)

    return {
        "vision_tower": clip_params_from_state_dict(sd, cfg.vision_config, device, dtype, prefix=vis_prefix),
        "projector": {
            "linear_1": get(proj_prefix + "linear_1.weight"),
            "linear_1_bias": get(proj_prefix + "linear_1.bias"),
            "linear_2": get(proj_prefix + "linear_2.weight"),
            "linear_2_bias": get(proj_prefix + "linear_2.bias"),
        },
        "image_newline": get(newline_key),
        "language_model": llama_params_from_state_dict(sd, cfg.text_config, device, dtype, prefix=lm_prefix),
    }


def load_llava_next(
    path: str,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    truncate_layers: int = 0,
) -> Tuple[dict, LlavaNextConfig]:
    """Local HF LLaVA-NeXT checkpoint dir -> (params, cfg).
    `truncate_layers` > 0 keeps only the first N language-model layers,
    whose weights alone reach the device, and sets the text depth to N."""
    import dataclasses

    from .hf_loader import load_hf_config, load_hf_state_dict, truncated

    dev = resolve_device(device)
    cfg = LlavaNextConfig.from_hf(load_hf_config(path))
    cfg = dataclasses.replace(cfg, text_config=truncated(cfg.text_config, truncate_layers))
    return llava_params_from_state_dict(load_hf_state_dict(path), cfg, dev, dtype), cfg
