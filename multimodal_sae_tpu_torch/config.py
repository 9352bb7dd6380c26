"""Configuration dataclasses of the port's cache and training paths.

Field-for-field copies of `multimodal_sae_tpu.config.SaeConfig`,
`TrainConfig`, `RunConfig`, `ExperimentConfig`, `FeatureConfig` and
`CacheConfig` (same names, defaults and order), so `cfg.json` and
`config.json` files and CLI flags are interchangeable between the two
packages.  Options whose paths a later slice
ports (int8, tensor and data parallelism, module distribution, multimodal
data) are accepted here and refused by the entry points that would need them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Literal, Optional


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
class TrainConfig:
    """SAE training configuration (reference train/sae/sae/config.py:29-79)."""

    sae: SaeConfig = field(default_factory=SaeConfig)

    batch_size: int = 8
    """Batch size measured in sequences."""

    grad_acc_steps: int = 1
    """Number of steps over which to accumulate gradients."""

    micro_acc_steps: int = 1
    """Chunk the activations into this number of microbatches for SAE training."""

    lr: Optional[float] = None
    """Base LR. If None, auto-chosen as 2e-4 / sqrt(num_latents / 2**14)."""

    lr_warmup_steps: int = 1000

    auxk_alpha: float = 0.0
    """Weight of the auxiliary (dead-latent) loss term."""

    adam_8bit: bool = False
    """Store Adam moments in 8-bit blockwise-quantized form (ops/adam8bit.py)."""

    dead_feature_threshold: int = 10_000_000
    """Number of tokens after which a feature is considered dead."""

    sae_dtype: str = "float32"
    """Parameter dtype for freshly initialized SAEs ("float32" or
    "bfloat16").  Ignored on resume (checkpoints carry their own dtype)."""

    approx_topk: bool = field(
        default=False,
        metadata={"help": "accepted for the JAX CLI's sake; the port always takes the exact "
                          "k-th value as the training threshold (the TPU's approximate top-k "
                          "unit has no counterpart here)"},
    )
    """The JAX package's approximate training threshold (the TPU's
    PartialReduce unit).  The port takes the exact threshold either way."""

    hookpoints: List[str] = field(default_factory=list)
    """List of hookpoints to train SAEs on (supports fnmatch wildcards)."""

    layers: List[int] = field(default_factory=list)
    """List of layer indices to train SAEs on."""

    layer_stride: int = 1
    """Stride between layers to train SAEs on."""

    distribute_modules: bool = False
    """One SAE copy per device group (not in this slice of the port)."""

    save_every: int = 1000
    """Save SAEs every `save_every` optimizer steps."""

    log_to_wandb: bool = True
    run_name: Optional[str] = None
    wandb_log_frequency: int = 1

    mm_data: bool = False
    """Multimodal training data (not in this slice of the port)."""

    def __post_init__(self):
        if self.layers and self.layer_stride != 1:
            raise ValueError("Cannot specify both `layers` and `layer_stride`.")


@dataclass
class RunConfig(TrainConfig):
    """`python -m multimodal_sae_tpu_torch` CLI configuration
    (reference train/sae/sae/__main__.py:25-63)."""

    model: str = field(default="EleutherAI/pythia-160m", metadata={"positional": True})
    """Name or path of the subject model."""

    dataset: str = field(
        default="togethercomputer/RedPajama-Data-1T-Sample",
        metadata={"positional": True},
    )
    """Path to the dataset to use for training."""

    split: str = "train"
    """Dataset split to use for training."""

    ctx_len: int = 2048
    """Context length to use for training."""

    hf_token: Optional[str] = None
    """Huggingface API token for downloading models."""

    load_in_8bit: bool = False
    """Load the subject in reduced precision (not in this slice of the port)."""

    int8_matmul: bool = False
    """W8A8 subject matmuls (not in this slice of the port)."""

    int8_vision: bool = False
    """W8A8 CLIP tower (not in this slice of the port)."""

    flash_attention: bool = False
    """Run the subject's attention through the causal flash-attention kernel."""

    tp: int = 0
    """Tensor-parallel degree (not in this slice of the port)."""

    dp: int = 0
    """In-process data parallelism (not in this slice of the port)."""

    max_examples: Optional[int] = None
    """Maximum number of examples to use for training."""

    resume: bool = False
    """Whether to try resuming from the checkpoint present at `run_name`."""

    seed: int = 42
    """Random seed for shuffling the dataset."""

    data_preprocessing_num_proc: int = 1
    """Number of processes to use for preprocessing data."""

    truncate_layers: int = 0
    """Keep only the first N transformer layers of the subject resident
    (0 = all); every trained hookpoint must be below N."""


@dataclass
class ExperimentConfig:
    """Interpretation-experiment configuration
    (reference sae_auto_interp/config.py:8-54)."""

    model: str = "EleutherAI/pythia-160m"
    """Name of the subject model."""

    dataset: str = "togethercomputer/RedPajama-Data-1T-Sample"
    """Path to the dataset."""

    sae_path: Optional[str] = None
    """Path to your trained sae. Should be local."""

    train_type: Literal["top", "random", "quantile"] = "top"
    """Type of sampler to use for training examples."""

    n_examples_train: int = 10
    """Number of examples to sample for training."""

    n_examples_test: int = 7
    """Number of examples to sample for testing."""

    n_quantiles: int = 10
    """Number of quantiles to sample."""

    n_random: int = 5
    """Number of random examples to sample."""

    explainer: str = "meta-llama/Meta-Llama-3.1-405B-Instruct-FP8"
    """The name of the explainer model."""

    explanation_dir: str = "./explanation_dir"
    """Dir to save your explanation result."""

    scores_dir: str = "./scores_dir"
    """Dir to save your scores result."""

    selected_layers: List[int] = field(default_factory=list)

    split: str = "train"
    """Dataset split to use."""

    save_dir: str = "./features_cache"
    """Save dir of previously cached features."""

    filters_path: Optional[str] = None
    """Json file mapping hookpoint -> list of feature indices to keep."""


@dataclass
class FeatureConfig:
    """Cached-feature dataset configuration (reference sae_auto_interp/config.py:57-72)."""

    width: int = 131072
    """Number of features in the autoencoder."""

    example_ctx_len: int = 64
    """Length of each example."""

    min_examples: int = 200
    """Minimum number of examples for a feature to be included."""

    max_examples: int = 10000
    """Maximum number of examples for a feature to be included."""

    n_splits: int = 2
    """Number of splits that features were divided into."""


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
