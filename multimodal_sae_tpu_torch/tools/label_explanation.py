"""Concept labels for refined explanations:

    python -m multimodal_sae_tpu_torch.tools.label_explanation \\
        --refined-explanation <json> --save-path <json> [--base-url http://localhost:8000]

The flags and output of the JAX package's `tools/label_explanation.py`: an
LLM behind an OpenAI-compatible endpoint (`clients.SRT`) gives each refined
explanation one of scene, object, part, material, texture or color,
CONCURRENCY requests at a time; explanations holding the "Unable to produce
descriptions" sentinel are skipped.  The labels are written in the order
the replies arrive.  `label_all` is the core, on a client."""

from __future__ import annotations

import argparse
import asyncio
import json

from ..clients import SRT
from ..prompt import CONCEPT_LABEL_PROMPT

CONCURRENCY = 8
GEN_KWARGS = {"max_tokens": 16}
SENTINEL = "Unable to produce descriptions"


async def label_all(client, explanations):
    semaphore = asyncio.Semaphore(CONCURRENCY)

    async def one(name, description):
        async with semaphore:
            reply = await client.generate(CONCEPT_LABEL_PROMPT.format(description=description), **GEN_KWARGS)
        return name, reply

    labels = {}
    pending = [
        asyncio.create_task(one(name, description))
        for name, description in explanations.items()
        if SENTINEL not in description
    ]
    for done in asyncio.as_completed(pending):
        name, reply = await done
        labels[name] = reply
    return labels


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--refined-explanation", type=str, help="The path of the refined explanation.")
    parser.add_argument("--save-path", type=str, help="The path to save your labels")
    parser.add_argument("--base-url", type=str, default="http://localhost:8000",
                        help="OpenAI-compatible endpoint of the labeling LLM")
    args = parser.parse_args(argv)

    with open(args.refined_explanation, "r") as f:
        explanations = json.load(f)

    client = SRT("meta-llama/Llama-3.1-70B-Instruct", tp=8, base_url=args.base_url)
    try:
        labels = asyncio.run(label_all(client, explanations))
    finally:
        client.clean()

    with open(args.save_path, "w") as f:
        json.dump(labels, f, indent=4)


if __name__ == "__main__":
    main()
