"""Explainer base types and file-backed explanation loaders
(reference sae_auto_interp/agents/explainers/explainer.py:12-45).

The `ExplainerResult` field names and the loader call signatures are the
pipeline interface (pipes pass records through by keyword); the I/O here is
plain-thread offloading rather than the reference's aiofiles.

Copied from multimodal_sae_tpu/agents/explainers/explainer.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
from abc import ABC, abstractmethod
from typing import NamedTuple

from ...features.features import FeatureRecord


class ExplainerResult(NamedTuple):
    record: FeatureRecord
    """The input record, forwarded untouched so downstream scorer pipes can
    key on it."""

    explanation: str
    """Natural-language description of what the feature fires on."""


class Explainer(ABC):
    @abstractmethod
    def __call__(self, record: FeatureRecord) -> ExplainerResult:
        pass


async def _load_json(path: str):
    """Read + parse one explanation file off the event loop."""
    text = await asyncio.to_thread(lambda: open(path).read())
    return json.loads(text)


async def explanation_loader(
    record: FeatureRecord,
    explanation_dir: str,
) -> ExplainerResult:
    """Load a previously saved explanation for this feature."""
    path = os.path.join(explanation_dir, f"{record.feature}.txt")
    return ExplainerResult(record, await _load_json(path))


async def random_explanation_loader(
    record: FeatureRecord,
    explanation_dir: str,
) -> ExplainerResult:
    """Control baseline: a random *other* feature's explanation.

    Deliberate fix over the reference: it compared `str(record.feature)`
    against the listing (which carries `.txt` suffixes), so the exclusion
    never matched and a feature could draw its OWN explanation as its
    "random" control — here the suffixed filename is excluded."""
    own = f"{record.feature}.txt"
    candidates = [
        name
        for name in os.listdir(explanation_dir)
        if name.endswith(".txt") and name != own
    ]
    if not candidates:
        raise FileNotFoundError(
            f"no OTHER feature's explanation in {explanation_dir!r} to use "
            f"as a random control for {record.feature} — the control needs "
            "at least two explained features"
        )
    path = os.path.join(explanation_dir, random.choice(candidates))
    return ExplainerResult(record, await _load_json(path))
