"""Detection scorer (behavior of reference
agents/scorers/simple/simple_scorer.py:26-118): the judge LLM rates each
highlighted example 0-3 against the feature explanation, five examples per
request, returning a Python list per group; malformed replies are dropped.

Copied from multimodal_sae_tpu/agents/scorers/simple/simple_scorer.py; it uses no jax.
"""

from __future__ import annotations

import re
from ast import literal_eval
from typing import List, NamedTuple, Optional

from ....features.features import Example, FeatureRecord
from ...utils import highlight, join_activations, normalize_examples
from .prompt import prompt

GROUP_SIZE = 5
_LIST_RE = re.compile(r"\[.*\]", re.DOTALL)


class SimpleScorerResult(NamedTuple):
    record: FeatureRecord
    """Feature record passed through."""

    scores: List[List[int]]
    """Rubric scores, one list per judged group."""

    max_activations: List[List[float]]
    """Max activation of each example in each judged group."""


def _parse_score_list(text: str) -> Optional[list]:
    """First bracketed list in the reply, literal-eval'd; None if absent or
    malformed (such groups are silently skipped, reference :73-78)."""
    match = _LIST_RE.search(text)
    if match is None:
        return None
    try:
        return literal_eval(match.group(0).strip())
    except Exception:
        return None


class SimpleScorer:
    name = "Simple"

    def __init__(
        self,
        client,
        tokenizer,
        verbose: bool = False,
        threshold: float = 0.6,
        activations: bool = False,
        **generation_kwargs,
    ):
        self.client = client
        self.tokenizer = tokenizer
        self.verbose = verbose
        self.threshold = threshold
        self.activations = activations
        self.generation_kwargs = generation_kwargs

    def _render_group(self, group: List[Example], explanation: str):
        lines = []
        for position, example in enumerate(group):
            lines.append(highlight(position, example, self.tokenizer, self.threshold))
            if self.activations:
                lines.append(join_activations(example, self.threshold))
        return prompt(examples="\n".join(lines), explanation=explanation)

    async def __call__(self, record: FeatureRecord):
        if self.activations:
            normalize_examples(record, record.train)

        groups = [
            record.train[start : start + GROUP_SIZE]
            for start in range(0, len(record.train), GROUP_SIZE)
        ]

        kept_scores, kept_prompts, kept_replies, kept_max = [], [], [], []
        for group in groups:
            messages = self._render_group(group, record.explanation)
            reply = await self.client.generate(messages, **self.generation_kwargs)
            scores = _parse_score_list(reply)
            if scores is None:
                continue
            kept_scores.append(scores)
            kept_prompts.append(messages[-1]["content"])
            kept_replies.append(reply)
            kept_max.append([float(ex.max_activation) for ex in group])

        result = SimpleScorerResult(
            record=record, scores=kept_scores, max_activations=kept_max
        )
        if self.verbose:
            return kept_prompts, kept_replies, result
        return result

    # Kept for API parity with the reference (simple_scorer.py:93-100).
    def parse_scores(self, text: str) -> str:
        match = _LIST_RE.search(text)
        return match.group(0).strip() if match else "Scores could not be parsed."
