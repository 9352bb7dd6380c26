"""Label refiner (behavior of reference
agents/scorers/segment/label_refiner.py:51-98): rewrites verbose feature
explanations into crisp entity labels suitable for a zero-shot object
detector.  Contract preserved: replies are parsed after an "[ANSWER]" marker
and the "Unable to produce descriptions" sentinel passes through untouched.

Copied from multimodal_sae_tpu/agents/scorers/segment/label_refiner.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
from typing import Dict

_ANSWER_RE = re.compile(r"\[ANSWER\]\s*(.*)", re.DOTALL)

PROMPT = """\
[GUIDELINES]
You are an AI assistant that turns free-form descriptions into short entity labels. Each description may mention one or more entities; rephrase it down to the key entity only. The cases you will meet, with examples, are below — follow them closely.

Always reply with "[ANSWER]" followed by the extracted entity. Thank you!

Case 1: Good Description
The description already names the entity directly.
Examples:

Description: The cell phone.
Output: [ANSWER] The cell phone

Description: The letters on the shipping containers.
Output: [ANSWER] The letters on the shipping containers

Case 2: Description includes additional words
The description wraps the entity in commentary; keep only the entity.
Examples:

Description: The images all display different models of Honda vehicles, suggesting the neuron is activated by the presence of Honda vehicles or the Honda logo.
Output: [ANSWER] Honda vehicles

Description: The neuron seems to be reacting to the word "ORD" on the billboard. It could be part of a larger word or phrase, but the neuron specifically highlights the letters "ORD." This suggests that the neuron might be specialized in recognizing or processing certain words or characters in images.
Output: [ANSWER] The word "ORD"

Case 3: Bad Description
The description carries no usable information.
Examples:

Description: Unable to produce descriptions.
Output: Unable to produce descriptions


[Description]
{description}
"""


def parse_answer(text: str) -> str:
    """Extract the text after [ANSWER]; fall back to an explicit parse-failure
    message embedding the raw reply (reference label_refiner.py:82-92)."""
    match = _ANSWER_RE.search(text)
    if match is None:
        return f"Response {text}. Explanation could not be parsed."
    return match.group(1).strip()


class LabelRefiner:
    def __init__(self, client, features: Dict[str, str], concurrency: int = 8):
        """`features` maps feature name -> raw explanation."""
        self.client = client
        self.features = features
        self.concurrency = max(1, concurrency)
        self.refine_features: Dict[str, str] = {}

    async def refine(self):
        semaphore = asyncio.Semaphore(self.concurrency)
        progress = _progress_bar(len(self.features))

        async def one(name: str, explanation: str):
            async with semaphore:
                reply = await self.client.generate(
                    PROMPT.format(description=explanation)
                )
            return name, reply

        self.refine_features = {}
        pending = [
            asyncio.create_task(one(name, explanation))
            for name, explanation in self.features.items()
        ]
        for done in asyncio.as_completed(pending):
            name, reply = await done
            self.refine_features[name] = parse_answer(reply)
            if progress is not None:
                progress.update(1)

    # API parity with the reference (label_refiner.py:82).
    def parse_explanation(self, text: str) -> str:
        return parse_answer(text)

    def save_result(self, save_path: str):
        parent = os.path.dirname(save_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(self.refine_features, f, indent=4)


def _progress_bar(total: int):
    try:
        from tqdm import tqdm

        return tqdm(total=total, desc="Refined...")
    except ImportError:
        return None
