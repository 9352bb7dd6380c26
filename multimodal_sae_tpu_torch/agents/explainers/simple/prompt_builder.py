"""Few-shot prompt assembly for the text explainer
(reference agents/explainers/simple/prompt_builder.py:6-65).

Copied from multimodal_sae_tpu/agents/explainers/simple/prompt_builder.py; it uses no jax.
"""

from __future__ import annotations

from typing import List, Optional

from .prompts import example, system


def build_examples(**kwargs):
    examples = []
    for i in range(1, 4):
        prompt, response = example(i, **kwargs)
        examples.extend(
            [
                {"role": "user", "content": prompt},
                {"role": "assistant", "content": response},
            ]
        )
    return examples


def build_prompt(
    examples,
    cot: bool = False,
    activations: bool = False,
    top_logits: Optional[List[str]] = None,
):
    logits = top_logits is not None

    messages = system(cot=cot, logits=logits, activations=activations)
    messages.extend(build_examples(cot=cot, logits=logits, activations=activations))

    user_start = f"\n{examples}\n"
    if logits:
        user_start += f"\nTop_logits: {top_logits}"

    messages.append({"role": "user", "content": user_start})
    return messages
