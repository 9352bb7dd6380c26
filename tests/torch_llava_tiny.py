"""A tiny LLaVA-NeXT for the port's tests (test_torch_clip.py,
test_torch_llava_next.py, test_torch_image_cache.py): an HF-layout state
dict drawn with numpy from a seed, read by the JAX package's loader, and
carried to the port by `convert.llava_params_from_jax`.  Image 32 with patch
16 (two tokens a side, four a tile), pinpoints of one and two tiles."""

import numpy as np
import torch
import transformers

PINPOINTS = [[32, 64], [64, 32], [64, 64]]
IMG_TOKEN = 256
BOS = 257
TEXT = dict(vocab_size=260, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0)
VISION = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
              image_size=32, patch_size=16)
OLD_LAYOUT = (("model.language_model.", "language_model.model."), ("lm_head.", "language_model.lm_head."),
              ("model.vision_tower.", "vision_tower."), ("model.multi_modal_projector.", "multi_modal_projector."),
              ("model.image_newline", "image_newline"))
"""Post-4.52 key prefixes and their pre-4.52 forms."""


def hf_config(hidden_act: str = "quick_gelu", **text) -> "transformers.LlavaNextConfig":
    return transformers.LlavaNextConfig(
        vision_config=transformers.CLIPVisionConfig(**VISION, hidden_act=hidden_act),
        text_config=transformers.LlamaConfig(**{**TEXT, **text}),
        image_grid_pinpoints=PINPOINTS,
        image_token_index=IMG_TOKEN,
        vision_feature_layer=-2,
        vision_feature_select_strategy="default",
    )


def numpy_state_dict(hf_cfg, seed: int = 0, old_layout: bool = False) -> dict:
    """Every key of `LlavaNextForConditionalGeneration(hf_cfg)`, filled from
    a numpy generator: matrices normal / sqrt(fan-in), norm weights near 1,
    biases and embeddings small."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in transformers.LlavaNextForConditionalGeneration(hf_cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in shapes.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if "norm" in key and key.endswith("weight"):
            x = 1.0 + 0.1 * x
        elif key.endswith("bias") or "embedding" in key:
            x = 0.1 * x
        elif key.endswith("image_newline"):
            x = x / np.sqrt(shape[0])
        elif len(shape) >= 2 and "embed_tokens" not in key:
            x = x / np.sqrt(np.prod(shape[1:]))
        if old_layout:
            for new, old in OLD_LAYOUT:
                if key.startswith(new):
                    key = old + key[len(new):]
        sd[key] = torch.from_numpy(x)
    return sd


def models(seed: int = 0, flash: bool = False, **text):
    """(JAX LlavaNextModel, port LlavaNextModel on the CPU) with the same
    fp32 weights."""
    import dataclasses

    from multimodal_sae_tpu.models import llava_next as jln
    from multimodal_sae_tpu_torch.convert import llava_params_from_jax
    from multimodal_sae_tpu_torch.models import llava_next as pln

    hf_cfg = hf_config(**text)
    jcfg = jln.LlavaNextConfig.from_hf(hf_cfg.to_dict())
    jcfg = dataclasses.replace(jcfg, text_config=dataclasses.replace(jcfg.text_config, flash_attention=flash))
    jmodel = jln.LlavaNextModel(jln.llava_params_from_state_dict(numpy_state_dict(hf_cfg, seed), jcfg), jcfg)
    cfg = pln.LlavaNextConfig.from_hf(hf_cfg.to_dict())
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, flash_attention=flash))
    return jmodel, pln.LlavaNextModel(llava_params_from_jax(jmodel.params, device="cpu"), cfg)


def images(sizes, seed: int = 0):
    """Random RGB PIL images of the given (height, width) sizes."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)) for h, w in sizes]
