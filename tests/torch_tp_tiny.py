"""A tiny LLaMA checkpoint for the tensor- and data-parallel tests
(test_torch_tp.py, test_torch_dp.py): 3 layers, hidden 64, 8 query heads
and 4 KV heads (so `--tp 2` gives each rank 4 and 2), MLP 128, vocab 256,
an untied head, weights drawn with numpy (normal / sqrt(fan-in), so logits
spread about 1), written as an HF checkpoint with a word-level tokenizer
whose EOS is "255"; and the grid SAE under which the caches are exact."""

import json
import os

import numpy as np

TP_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
               num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128)
EOS = 255


def write_checkpoint(path, seed: int = 0) -> str:
    """The tiny LLaMA as a local HF checkpoint directory at `path`."""
    import torch
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    path = str(path)
    cfg = transformers.LlamaConfig(**TP_TINY, tie_word_embeddings=False, eos_token_id=EOS, bos_token_id=0)
    model = transformers.LlamaForCausalLM(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                w = 1 + 0.1 * rng.standard_normal(p.shape)
            elif p.ndim == 2 and "embed_tokens" not in name:
                w = rng.standard_normal(p.shape) / np.sqrt(p.shape[1])
            else:
                w = rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(w.astype(np.float32)))
    model.save_pretrained(path, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({str(i): i for i in range(TP_TINY["vocab_size"])}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0", eos_token=str(EOS)).save_pretrained(path)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": EOS}, f)
    return path


def grid_sae_params(d_in: int, width: int = 64, seed: int = 1) -> dict:
    """An SAE whose encoder lies on a grid of 1/16 and b_dec on one of 1/8,
    latent j's bias -0.5 + j * 2^-16: with hidden states on the drivers'
    grid (`common.on_grid`) every encoder product and sum is exact in fp32,
    in any order, and the top-k is one set."""
    rng = np.random.default_rng(seed)
    return {
        "W_enc": (rng.integers(-8, 9, size=(d_in, width)) / 16).astype(np.float32),
        "b_enc": (-0.5 + np.arange(width) * 2.0**-16).astype(np.float32),
        "W_dec": (rng.integers(-8, 9, size=(width, d_in)) / 16).astype(np.float32),
        "b_dec": (rng.integers(-4, 5, size=d_in) / 8).astype(np.float32),
    }


def write_grid_sae(path, hook: str, d_in: int, k: int = 4, width: int = 64) -> str:
    """The grid SAE saved by the port under `{path}/{hook}`; returns `path`."""
    import torch

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.sae import Sae

    params = {name: torch.from_numpy(a) for name, a in grid_sae_params(d_in, width).items()}
    Sae(d_in, SaeConfig(num_latents=width, k=k), params=params).save_to_disk(os.path.join(str(path), hook))
    return str(path)
