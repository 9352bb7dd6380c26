"""Feature example types and image-mask utilities
(multimodal_sae_tpu/features/features.py).

`Example`/`ImageExample` records, `upsample_mask`'s bilinear activation-mask
upsampling and `prepare_image_examples`' highlighted-region composites,
including the llava-hf quirk of using the plain-resized image (not the
anyres-padded one) for the base image feature.  Arrays are numpy and images
PIL.  PIL is imported inside the image functions only: the text path, and
the machine with the card, run without it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, TypeVar, Union

import numpy as np


@dataclass
class Example:
    tokens: np.ndarray
    """(seq,) token ids."""

    activations: np.ndarray
    """(seq,) activation per token."""

    def __hash__(self) -> int:
        return hash(tuple(np.asarray(self.tokens).tolist()))

    def __eq__(self, other: "Example") -> bool:
        return np.asarray(self.tokens).tolist() == np.asarray(other.tokens).tolist()

    @property
    def max_activation(self):
        return float(np.max(self.activations))


@dataclass(eq=False)
class ImageExample(Example):
    image: Any = None
    """The example's PIL image."""

    activation_image: Any = None
    """The image with only its activated regions visible (PIL)."""

    mask: Any = None
    """The upsampled activation mask (PIL, mode "L")."""


ExampleType = TypeVar("ExampleType", bound=Union[Example, ImageExample])


def prepare_examples(tokens, activations) -> List[Example]:
    return [
        Example(tokens=np.asarray(toks), activations=np.asarray(acts))
        for toks, acts in zip(tokens, activations)
    ]


def upsample_mask(mask: np.ndarray, image_size: Tuple[int, int], value: int = 224, resample=None):
    """Binary activation mask -> bilinear-upsampled PIL "L" mask: positions
    with activation < 1e-5 get `value` (background), active positions 0,
    then resize with `resample` (default `Image.BILINEAR`)."""
    from PIL import Image

    if resample is None:
        resample = Image.BILINEAR
    mask = (np.asarray(mask) < 1e-5).astype(np.int32) * value
    mask_image = Image.fromarray(mask.astype(np.uint8), mode="L")
    return mask_image.resize(image_size, resample)


def prepare_image_examples(
    tokens, activations, images, processor=None, num_image_tokens: Optional[int] = None
) -> List[ImageExample]:
    """Highlighted-region image examples: the first `num_image_tokens`
    positions of each activation row form a (patch, patch) grid (576 ->
    24 x 24 for CLIP-336, 729 -> 27 x 27 for siglip-384), upsampled to a
    mask and composited so only the activated regions of the plain-resized
    image stay visible."""
    from PIL import Image

    if num_image_tokens is None:
        num_image_tokens = getattr(processor, "num_image_tokens", 576) if processor is not None else 576
    base_img_tokens = num_image_tokens
    patch_size = int(round(base_img_tokens**0.5))
    assert patch_size * patch_size == base_img_tokens, base_img_tokens
    image_size = 384 if patch_size == 27 else 336

    activations = [np.asarray(a) for a in activations]
    base_image_activations = [a[:base_img_tokens].reshape(patch_size, patch_size) for a in activations]
    upsampled_image_mask = [upsample_mask(a, (image_size, image_size)) for a in base_image_activations]
    background = Image.new("L", (image_size, image_size), 0).convert("RGB")
    # llava-hf takes the plainly resized image (not the padded one) as the
    # base image feature.
    resized_image = [im.resize((image_size, image_size)) for im in images]
    activation_images = [
        Image.composite(background, im, upsampled_mask).convert("RGB")
        for im, upsampled_mask in zip(resized_image, upsampled_image_mask)
    ]
    return [
        ImageExample(
            tokens=np.asarray(toks),
            activations=acts,
            image=image,
            activation_image=activation_image,
            mask=mask,
        )
        for toks, acts, image, activation_image, mask in zip(
            tokens, activations, images, activation_images, upsampled_image_mask
        )
    ]


@dataclass
class Feature:
    module_name: str
    feature_index: int

    def __repr__(self) -> str:
        return f"{self.module_name}_feature{self.feature_index}"


class FeatureRecord:
    """Explanation/example record for one feature (reference features.py:102-127)."""

    def __init__(self, feature: Feature):
        self.feature = feature
        self.train: Optional[List[ExampleType]] = None
        self.explanation: Optional[str] = None
        self.examples: Optional[List[ExampleType]] = None

    @property
    def max_activation(self):
        return self.examples[0].max_activation

    def save(self, directory: str, save_examples: bool = False):
        path = f"{directory}/{self.feature}.json"
        serializable = dict(self.__dict__)
        if not save_examples:
            serializable.pop("examples", None)
            serializable.pop("train", None)
            serializable.pop("test", None)
        serializable.pop("feature", None)
        with open(path, "wb") as f:
            f.write(json.dumps(serializable, default=_json_default).encode())


def _json_default(o):
    import dataclasses

    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        # Example/ImageExample; their array fields recurse through here.
        return dataclasses.asdict(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    try:
        from PIL.Image import Image as _PILImage
    except ImportError:
        _PILImage = None
    if _PILImage is not None and isinstance(o, _PILImage):
        # A PIL image is written as base64 PNG.
        import base64
        import io

        buf = io.BytesIO()
        o.save(buf, format="PNG")
        return {"__pil_png_b64__": base64.b64encode(buf.getvalue()).decode()}
    raise TypeError(f"not JSON serializable: {type(o)}")
