"""Text feature explainer (behavior of reference
agents/explainers/simple/simple.py:10-92): renders the train examples with
`<<...>>` activation highlighting (optionally with quantized activation
values and top-logit lists), queries the explainer LLM, and parses the final
`[EXPLANATION]:` line.

Copied from multimodal_sae_tpu/agents/explainers/simple/simple.py; it uses no jax.
"""

from __future__ import annotations

import re

from ...utils import highlight, join_activations, normalize_examples
from ..explainer import Explainer, ExplainerResult
from .prompt_builder import build_prompt

_EXPLANATION_RE = re.compile(r"\[EXPLANATION\]:\s*(.*)", re.DOTALL)


def parse_explanation_text(reply: str) -> str:
    match = _EXPLANATION_RE.search(reply)
    return match.group(1).strip() if match else "Explanation could not be parsed."


class SimpleExplainer(Explainer):
    name = "Simple"

    def __init__(
        self,
        client,
        tokenizer,
        verbose: bool = False,
        cot: bool = False,
        logits: bool = False,
        activations: bool = False,
        threshold: float = 0.6,
        **generation_kwargs,
    ):
        self.client = client
        self.tokenizer = tokenizer
        self.verbose = verbose
        self.cot = cot
        self.logits = logits
        self.activations = activations
        self.threshold = threshold
        self.generation_kwargs = generation_kwargs

    def _render_examples(self, examples) -> str:
        lines = []
        for position, example in enumerate(examples, start=1):
            lines.append(highlight(position, example, self.tokenizer, self.threshold))
            if self.activations:
                lines.append(join_activations(example, self.threshold))
        return "\n".join(lines)

    async def __call__(self, record):
        if self.activations:
            normalize_examples(record, record.train)

        top_logits = record.top_logits if self.logits else None
        messages = build_prompt(
            examples=self._render_examples(record.train),
            cot=self.cot,
            activations=self.activations,
            top_logits=top_logits,
        )

        reply = await self.client.generate(messages, **self.generation_kwargs)
        result = ExplainerResult(
            record=record, explanation=parse_explanation_text(reply)
        )
        if self.verbose:
            return messages[-1]["content"], reply, result
        return result

    # API parity with the reference (simple.py:60-68).
    def parse_explanation(self, text: str) -> str:
        return parse_explanation_text(text)
