"""Shared interpretation-layer utilities (multimodal_sae_tpu/interp_utils.py):
filter, explanation, SAE and tokenizer loaders, the llava image-token span
lookup and the notebook display of a record."""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike
from .features import FeatureRecord
from .sae import Sae

logger = logging.getLogger(__name__)


def load_filter(path: str) -> Dict[str, np.ndarray]:
    """Json {hookpoint: [feature ids]} -> arrays (reference utils.py:44-48)."""
    with open(path) as f:
        filt = json.load(f)
    return {key: np.asarray(value, dtype=np.int64) for key, value in filt.items()}


def load_explanation(explanation_dir: str) -> Dict[str, str]:
    """Merge the `{module}.json` append-list files of an explain run into
    {feature: explanation} (reference utils.py:51-65): each file holds a list
    of {feature_name: explanation, "prompt": ...} dicts.  Only `*.json`
    files are read; an unparsable one is skipped with a warning."""
    explanations: Dict[str, str] = {}
    files = [
        e
        for e in os.listdir(explanation_dir)
        if e.endswith(".json") and os.path.isfile(os.path.join(explanation_dir, e))
    ]
    for file in files:
        path = os.path.join(explanation_dir, file)
        with open(path, "r") as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError as e:
                logger.warning(f"skipping unparsable explanation file {path}: {e}")
                continue
        for da in data:
            for key_name, content in da.items():
                if key_name != "prompt":
                    explanations[key_name] = content
    return explanations


def load_saes(
    sae_path: str,
    filters: Optional[Dict[str, np.ndarray]] = None,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
    decoder: bool = False,
    int8_encoder: bool = False,
) -> Dict[str, Sae]:
    """One SAE per hookpoint from the local directory or HuggingFace
    repository `sae_path` (reference utils.py:106-127): the filter's
    hookpoints when a filter is given, else every hookpoint directory.  A
    name that is no local path resolves through `huggingface_hub`
    (`Sae.load_from_hub`, `Sae.load_many`; its cache serves it offline
    under `HF_HUB_OFFLINE=1`).  The cache path never decodes, so
    decoders stay on disk unless `decoder` (steering decodes).
    `int8_encoder` quantises each W_enc for the W8A8 encode
    (`Sae.quantize_encoder`; it moves top-k ties)."""
    if filters is not None:
        saes = {name: Sae.load_from_hub(sae_path, name, dtype, decoder=decoder, device=device) for name in filters}
    else:
        saes = Sae.load_many(sae_path, dtype=dtype, decoder=decoder, device=device)
    if int8_encoder:
        for sae in saes.values():
            sae.quantize_encoder()
    return saes


def load_single_sae(
    sae_path: str, module_name: str, dtype: Optional[torch.dtype] = None, device: DeviceLike = None
) -> Sae:
    """The SAE of one hookpoint, with its decoder, from the local directory
    or HuggingFace repository `sae_path` (reference utils.py:130-135)."""
    return Sae.load_from_hub(sae_path, module_name, dtype, device=device)


def get_llava_image_pos(input_ids: List[int], image_tok: int) -> Tuple[int, int]:
    """(start, negative end) span of the image tokens within expanded input
    ids, for a single image (reference utils.py:187-198)."""
    input_ids = list(input_ids)
    image_pos = input_ids.index(image_tok)
    prev = image_pos
    after = -(len(input_ids) - image_pos) + 1
    return prev, after


def display(record: FeatureRecord, tokenizer, threshold: float = 0.0, n: int = 10):
    """Notebook HTML rendering of a record's activating spans
    (reference utils.py:201-230); needs IPython.  `IPython.display` holds
    `HTML` and `display` in every IPython release (`IPython.core.display`,
    where the JAX package looks, lost `display` in IPython 8)."""
    from IPython.display import HTML, display as ipy_display

    def _to_string(tokens, activations) -> str:
        result = []
        i = 0
        max_act = max(activations)
        _threshold = max_act * threshold
        while i < len(tokens):
            if activations[i] > _threshold:
                result.append("<mark>")
                while i < len(tokens) and activations[i] > _threshold:
                    result.append(tokens[i])
                    i += 1
                result.append("</mark>")
            else:
                result.append(tokens[i])
                i += 1
        return "".join(result)

    strings = [
        _to_string(
            tokenizer.batch_decode([[t] for t in np.asarray(example.tokens)]),
            np.asarray(example.activations),
        )
        for example in record.examples[:n]
    ]
    ipy_display(HTML("<br><br>".join(strings)))


def load_tokenizer(model: str):
    """The checkpoint's tokenizer with left padding and EOS as its pad
    token (reference utils.py:233-241)."""
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model, padding_side="left")
    tokenizer.pad_token = tokenizer.eos_token
    return tokenizer
