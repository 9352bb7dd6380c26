"""Shared explainer/scorer text utilities
(reference sae_auto_interp/agents/utils.py:9-63): `<<token>>` highlighting of
above-threshold spans, activation-tuple rendering, and 0-10 activation
normalization.

Copied from multimodal_sae_tpu/agents/utils.py; it uses no jax.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..features import Example, FeatureRecord


def highlight(index: int, example: Example, tokenizer, threshold: float) -> str:
    """Render an example with activating token spans wrapped in << >>:
    consecutive above-threshold tokens share one marker pair."""
    str_toks = tokenizer.batch_decode([[t] for t in np.asarray(example.tokens)])
    example.str_toks = str_toks
    cutoff = example.max_activation * threshold
    active = np.asarray(example.activations) > cutoff

    from itertools import groupby

    parts = [f"Example {index}: "]
    pos = 0
    for is_active, run in groupby(active.tolist()):
        n = sum(1 for _ in run)
        span = "".join(str_toks[pos : pos + n])
        parts.append(f"<<{span}>>" if is_active else span)
        pos += n
    return "".join(parts)


def join_activations(example: Example, threshold: float) -> str:
    """`Activations: ("tok" : value), ...` for above-threshold tokens."""
    activations = []
    threshold = example.max_activation * threshold
    acts = np.asarray(example.activations)
    for i, normalized in enumerate(example.normalized_activations):
        if acts[i] > threshold:
            activations.append((example.str_toks[i], int(normalized)))
    acts_str = ", ".join(f'("{tok}" : {val})' for tok, val in activations)
    return "Activations: " + acts_str


def normalize_examples(record: FeatureRecord, train: List[Example]):
    """Quantize activations to 0-10 relative to the feature's max."""
    max_activation = record.examples[0].max_activation
    for example in train:
        example.normalized_activations = np.floor(
            10 * np.asarray(example.activations) / max_activation
        )
