"""PyTorch + CUDA port of `multimodal_sae_tpu` for one NVIDIA H100.

Five paths run so far.  The text activation cache: a frozen LLaMA-3
subject's hidden states at a hookpoint go through a TopK SAE encoder, an
exact wide top-k, and a COO extractor into
`{module}/{start}_{end}.safetensors` splits that are byte-compatible with
the JAX package's.  Attribution patching on the text subject
(`features.patching`): per SAE feature, the gradient-times-difference
saliency of ablating it at the splice.  SAE training (`train.SaeTrainer`,
`python -m multimodal_sae_tpu_torch`): the TopK forward with AuxK and
Multi-TopK, Adam, dead-feature counters and checkpoints the JAX trainer
reads and writes.  The LLaVA-NeXT image cache (`FeatureImageCache`).  And
reading a cache back (`features.FeatureDataset`): host numpy that turns
the splits into the feature records explain and score consume, with the
decoder statistics and PCA on the card.  The kernels (block max, causal
flash attention forward and backward, the row gather, SAE decode and its
backward's dvals) are hand-written CUDA for sm_90a under `csrc/`, built on
first use.

The package imports torch, numpy and the standard library only; it never
imports jax or `multimodal_sae_tpu`.  Importing it builds nothing and
touches no device.
"""
