"""Configuration dataclasses of the port's cache path.

Field-for-field copies of `multimodal_sae_tpu.config.SaeConfig` and
`CacheConfig` (same names, defaults and order), so `cfg.json` files and CLI
flags are interchangeable between the two packages.  Options whose paths a
later slice ports (int8, tensor and data parallelism) are accepted here and
refused by the CLI.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SaeConfig:
    """Configuration of a TopK sparse autoencoder (reference
    sae_auto_interp/sae/config.py:8-29)."""

    expansion_factor: int = 32
    """Multiple of the input dimension to use as the SAE dimension."""

    normalize_decoder: bool = True
    """Normalize the decoder weights to have unit norm."""

    num_latents: int = 0
    """Number of latents to use. If 0, use `expansion_factor`."""

    k: int = 32
    """Number of nonzero features."""

    multi_topk: bool = False
    """Use Multi-TopK loss."""

    signed: bool = False
    """Legacy-checkpoint compatibility flag."""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SaeConfig":
        """Build from a dict, ignoring unknown keys."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def num_latents_for(self, d_in: int) -> int:
        return self.num_latents or d_in * self.expansion_factor


@dataclass
class CacheConfig:
    """Activation-caching CLI configuration (reference
    sae_auto_interp/config.py:75-117)."""

    model: str = field(default="EleutherAI/pythia-160m", metadata={"positional": True})
    """Name of the subject model."""

    dataset: str = field(
        default="togethercomputer/RedPajama-Data-1T-Sample",
        metadata={"positional": True},
    )
    """Path to the dataset."""

    sae_path: Optional[str] = None
    """Path to the trained sae, local dir or hub name."""

    batch_size: int = 32
    """Number of sequences to process in a batch."""

    load_in_8bit: bool = False
    """Load the model in reduced precision (not in this slice of the port)."""

    int8_matmul: bool = False
    """W8A8 subject matmuls (not in this slice of the port)."""

    int8_vision: bool = False
    """W8A8 CLIP tower (not in this slice of the port)."""

    flash_attention: bool = False
    """Run the subject's attention through the causal flash-attention kernel
    (ops/flash_attention.py) instead of eager attention."""

    truncate_layers: int = 0
    """Keep only the first N subject transformer layers resident (0 = all).
    Every cached hookpoint must be below N."""

    split: str = "train"
    """Dataset split to use."""

    n_splits: int = 2
    """Number of feature-axis splits to divide .safetensors into."""

    ctx_len: int = 2048
    """Context length. Each batch is shape (batch_size, ctx_len)."""

    hf_token: Optional[str] = None
    """Huggingface API token for downloading models."""

    save_dir: str = "./features_cache"
    """Save dir for the cached features."""

    verbosity: str = "INFO"
    """Verbosity level."""

    filters_path: Optional[str] = None
    """Json file mapping hookpoint -> list of feature indices to keep."""

    sae_int8: bool = False
    """int8 SAE encoder (not in this slice of the port)."""

    tp: int = 0
    """Tensor-parallel degree (not in this slice of the port)."""

    dp: int = 0
    """In-process data parallelism (not in this slice of the port)."""
