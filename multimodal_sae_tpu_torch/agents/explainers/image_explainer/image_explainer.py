"""Image feature explainer (behavior of reference
agents/explainers/image_explainer/image_explainer.py:16-66): base64-encodes
the top activation-highlight composites, asks a multimodal LLM what the
visible regions share, and parses the `[EXPLANATION]:` line — on failure the
raw reply is embedded in the parse-failure message.

Copied from multimodal_sae_tpu/agents/explainers/image_explainer/image_explainer.py; it uses no jax.
"""

from __future__ import annotations

import re

from ....clients.client import encode_image_base64
from ....features import FeatureRecord
from ..explainer import Explainer, ExplainerResult
from .prompts import build_prompt

_EXPLANATION_RE = re.compile(r"\[EXPLANATION\]:\s*(.*)", re.DOTALL)


def parse_image_explanation(reply: str) -> str:
    match = _EXPLANATION_RE.search(reply)
    if match is None:
        return f"Response {reply}. Explanation could not be parsed."
    return match.group(1).strip()


class ImageExplainer(Explainer):
    name = "Simple"

    def __init__(self, client, verbose: bool = False, **generation_kwargs):
        self.client = client
        self.verbose = verbose
        self.generation_kwargs = generation_kwargs

    async def __call__(self, record: FeatureRecord):
        encoded = [
            encode_image_base64(example.activation_image) for example in record.train
        ]
        messages = build_prompt(encoded)
        reply = await self.client.generate(messages, **self.generation_kwargs)
        result = ExplainerResult(
            record=record, explanation=parse_image_explanation(reply)
        )
        if self.verbose:
            return messages[-1]["content"], reply, result
        return result

    # API parity with the reference (image_explainer.py:46-66).
    def parse_explanation(self, text: str) -> str:
        return parse_image_explanation(text)

    def encode_images(self, image):
        return encode_image_base64(image)
