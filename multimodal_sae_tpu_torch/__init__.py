"""PyTorch + CUDA port of `multimodal_sae_tpu` for one NVIDIA H100.

Every path of the JAX package runs here: the text and LLaVA-NeXT
activation caches (a frozen subject's hidden states at a hookpoint go
through a TopK SAE encoder, an exact wide top-k and a COO extractor into
`{module}/{start}_{end}.safetensors` splits byte-compatible with the JAX
package's); attribution patching at one splice or several
(`features.patching`); SAE training (`train.SaeTrainer`, `python -m
multimodal_sae_tpu_torch`), data-parallel or module-sharded across
processes (`parallel`, `--distribute_modules`); reading a cache back
into feature records (`features.FeatureDataset`) with the decoder
statistics and PCA; the explain and score layer (`agents`, `clients`,
`pipeline`, CLIP's full model); steering and generation; and int8
subjects and SAE encoders (`models.quant`).  The kernels (block max,
causal flash attention forward and backward, the row gather, SAE decode
and its backward's dvals) are hand-written CUDA for sm_90a under `csrc/`,
built on first use.

The package imports torch, numpy and the standard library only; it never
imports jax or `multimodal_sae_tpu`.  Importing it builds nothing and
touches no device.
"""

from .config import CacheConfig, ExperimentConfig, FeatureConfig, SaeConfig, TrainConfig
from .sae import Sae

__all__ = [
    "Sae",
    "SaeConfig",
    "TrainConfig",
    "CacheConfig",
    "FeatureConfig",
    "ExperimentConfig",
]
