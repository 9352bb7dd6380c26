"""Example samplers (multimodal_sae_tpu/features/samplers.py): top, random
and quantile selection of constructed examples into `record.train`, with
the fixed seed 22.

The selections draw from Python's global `random` after `random.seed(...)`.
That call sequence is observable: the same calls in the same order select
the same examples as the JAX package and the reference, so it is kept
exactly, the quantile quirk included."""

from __future__ import annotations

import logging
import random
from collections import deque
from typing import Dict, List, Literal

from ..config import ExperimentConfig
from .features import Example, FeatureRecord

logger = logging.getLogger(__name__)


class SkipRecord(Exception):
    """Raised by a constructor/sampler to drop a record from the loader
    stream (FeatureDataset.load catches it).  Deviation from the reference:
    its `sample_with_explanation` KeyErrors on a cached feature the explain
    run never covered (reference samplers.py:86-90), aborting the whole
    scoring pipeline; we skip the record with a warning instead."""


def split_activation_quantiles(
    examples: List[Example], n_quantiles: int, n_samples: int, seed: int = 22
):
    """Threshold-based quantiles over max activation (reference samplers.py:9-31).

    Deviation from the reference transcription: the reference assumes an
    ascending queue whose FIRST element it nonetheless reads as the maximum —
    with the descending example lists the constructors actually produce,
    every threshold quantile comes out empty and `random.sample` raises
    (the function is unreachable from the reference's own CLIs).  Here the
    true max sets the thresholds, the queue is sorted ascending, and
    sampling caps at the quantile size."""
    random.seed(seed)
    max_activation = max(e.max_activation for e in examples)
    thresholds = [max_activation * i / n_quantiles for i in range(1, n_quantiles)]

    samples = []
    queue = deque(sorted(examples, key=lambda e: e.max_activation))
    for threshold in thresholds:
        quantile = []
        while queue and queue[0].max_activation < threshold:
            quantile.append(queue.popleft())
        samples.append(random.sample(quantile, min(n_samples, len(quantile))))
    samples.append(random.sample(list(queue), min(n_samples, len(queue))))
    return samples


def split_quantiles(
    examples: List[Example], n_quantiles: int, n_samples: int, seed: int = 22
):
    """Evenly-chunked quantile sampling (reference samplers.py:34-49)."""
    random.seed(seed)
    quantile_size = len(examples) // n_quantiles
    samples = []
    for i in range(n_quantiles):
        quantile = examples[i * quantile_size : (i + 1) * quantile_size]
        samples.extend(random.sample(quantile, min(len(quantile), n_samples)))
    return samples


def train(
    examples: List[Example],
    n_train: int,
    train_type: Literal["top", "random", "quantile"],
    seed: int = 22,
    n_quantiles: int = 10,
):
    """(reference samplers.py:52-67)"""
    if train_type == "top":
        return examples[:n_train]
    elif train_type == "random":
        random.seed(seed)
        return random.sample(examples, n_train)
    elif train_type == "quantile":
        # Reference-pinned quirk (reference samplers.py:65): `seed` is NOT
        # forwarded — split_quantiles always re-seeds with its own default
        # 22, so quantile draws ignore the caller's seed exactly as the
        # reference's do. Forwarding it would break selection bit-parity.
        return split_quantiles(examples, n_quantiles, n_train)
    raise ValueError(f"Invalid train_type: {train_type}")


def sample(record: FeatureRecord, cfg: ExperimentConfig):
    """Fill record.train (reference samplers.py:70-83)."""
    record.train = train(
        record.examples,
        n_train=cfg.n_examples_train,
        train_type=cfg.train_type,
        n_quantiles=cfg.n_quantiles,
    )


def sample_with_explanation(
    record: FeatureRecord, cfg: ExperimentConfig, explanations: Dict[str, str]
):
    """Sample + attach a previously-saved explanation (reference samplers.py:86-90)."""
    sample(record, cfg)
    try:
        record.explanation = explanations[f"{record.feature}"]
    except KeyError:
        logger.warning(
            f"No explanation for {record.feature}; skipping (was it excluded "
            "from the explain run by filters/--selected_layers?)"
        )
        raise SkipRecord(f"{record.feature}") from None
