"""Steering-effect labelling CLI (behavior of reference
launch/features/filter_steering.py:29-64):

    python -m multimodal_sae_tpu_torch.launch.features.filter_steering \\
        --explanation-dir <dir> --steering-path <module>.json

An LLM rates each steering result 1-4 with the steering-filter rubric, and
the json is updated in place with a `category` field.

Copied from multimodal_sae_tpu/launch/features/filter_steering.py; it uses
no jax.
"""

from __future__ import annotations

import argparse
import asyncio
import json

from ...clients import SRT
from ...interp_utils import load_explanation
from ...prompt import STEERING_FILTER_PROMPT

JUDGE_MODEL = "meta-llama/Llama-3.1-70B-Instruct"


async def label_steering_effects(client, steering_result, concurrency: int = 8):
    semaphore = asyncio.Semaphore(concurrency)

    async def one(name: str):
        entry = steering_result[name]
        request = STEERING_FILTER_PROMPT.format(
            label=entry.get("explanation", ""),
            original=entry["original_resps"],
            steered=entry["clamped_resps"],
        )
        async with semaphore:
            return name, await client.generate(request)

    pending = [asyncio.create_task(one(name)) for name in steering_result]
    for done in asyncio.as_completed(pending):
        name, category = await done
        steering_result[name]["category"] = category


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--explanation-dir", "-e", type=str)
    parser.add_argument("--steering-path", "-s", type=str)
    args = parser.parse_args(argv)

    with open(args.steering_path, "r") as f:
        steering_result = json.load(f)
    explanations = load_explanation(args.explanation_dir)
    for name, explanation in explanations.items():
        if name in steering_result:
            steering_result[name]["explanation"] = explanation

    client = SRT(model=JUDGE_MODEL, tp=8)
    try:
        asyncio.run(label_steering_effects(client, steering_result))
    finally:
        client.clean()

    with open(args.steering_path, "w", encoding="utf-8") as f:
        json.dump(steering_result, f, indent=4, ensure_ascii=False)


if __name__ == "__main__":
    main()
