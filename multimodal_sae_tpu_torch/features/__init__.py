from .features import (
    Example,
    Feature,
    FeatureRecord,
    ImageExample,
    prepare_examples,
    prepare_image_examples,
    upsample_mask,
)
from .cache import Cache, FeatureCache, FeatureImageCache, topk_latents_step
from .loader import BufferOutput, FeatureDataset, TensorBuffer
from .constructors import (
    default_constructor,
    pool_max_activation_windows,
    pool_max_activations_windows_image,
    random_activation_windows,
    random_activations_image,
)
from .samplers import SkipRecord, sample, sample_with_explanation

__all__ = [
    "Example",
    "ImageExample",
    "Feature",
    "FeatureRecord",
    "prepare_examples",
    "prepare_image_examples",
    "upsample_mask",
    "Cache",
    "FeatureCache",
    "FeatureImageCache",
    "topk_latents_step",
    "BufferOutput",
    "TensorBuffer",
    "FeatureDataset",
    "default_constructor",
    "pool_max_activation_windows",
    "pool_max_activations_windows_image",
    "random_activation_windows",
    "random_activations_image",
    "SkipRecord",
    "sample",
    "sample_with_explanation",
]


def __getattr__(name):
    # Imported on first use, as in the JAX package.
    if name == "Attribution":
        from .patching import Attribution

        return Attribution
    raise AttributeError(name)
