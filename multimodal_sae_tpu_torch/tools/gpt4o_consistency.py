"""GPT-4o consistency judgements of activated images per concept label:

    OPENAI_API_ENDPOINT=<azure endpoint> OPENAI_API_KEY=<key> \\
    python -m multimodal_sae_tpu_torch.tools.gpt4o_consistency \\
        --explanation-dir <dir> --label-file <json> --save-path <json>

The flags and output of the JAX package's `tools/gpt4o_consistency.py`:
the first 100 features of each label are judged 0/1 by the model from
their activated images (`{explanation_dir}/images/model_layers_24/
<feature>/activated_images/*.*`) and their explanation, one request at a
time (`clients.OpenAIClient`).  The result file is the resume cache: a
feature already judged is skipped, one whose request failed (-1) is asked
again, and the file is rewritten through a temporary file and
`os.replace` after every reply, so that a run that dies leaves it whole.
`judge_all` is the core, on a client and a message builder."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
from collections import defaultdict
from glob import glob
from typing import Callable, Dict, List

from ..clients import OpenAIClient
from ..interp_utils import load_explanation
from ..prompt import GPT_CONSISTENCY_PROMPT

FEATURES_PER_LABEL = 100
FAILED = -1


def parse_argument(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--explanation-dir", type=str)
    parser.add_argument("--label-file", type=str)
    parser.add_argument("--save-path", type=str, help="Result path; doubles as resume cache")
    return parser.parse_args(argv)


def sample_features(labels: Dict[str, str]) -> List[str]:
    """The first FEATURES_PER_LABEL features of each label, labels in the
    order they first appear."""
    by_label = defaultdict(list)
    for feature, label in labels.items():
        by_label[label].append(feature)
    return [feature for features in by_label.values() for feature in features[:FEATURES_PER_LABEL]]


def write_atomic(scores: dict, save_path: str) -> None:
    tmp = save_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(scores, f, indent=4)
    os.replace(tmp, save_path)


async def judge_all(client, features: List[str], scores: dict, messages: Callable[[str], list],
                    save_path: str) -> dict:
    """Ask `client` about each feature of `features` not yet in `scores`
    or failed there (-1), one at a time; a request that raises scores -1.
    `scores` is updated and rewritten to `save_path` after every reply."""
    sem = asyncio.Semaphore(1)

    async def _generate(feature):
        async with sem:
            try:
                result = await client.generate(messages(feature))
            except Exception:
                result = FAILED
            return feature, result

    tasks = [asyncio.create_task(_generate(feature)) for feature in features
             if scores.get(feature, FAILED) == FAILED]
    for completed in asyncio.as_completed(tasks):
        feature, result = await completed
        scores[feature] = result
        write_atomic(scores, save_path)
    return scores


def main(argv=None):
    args = parse_argument(argv)
    from PIL import Image

    explanation = load_explanation(args.explanation_dir)
    with open(args.label_file, "r") as f:
        label_file = json.load(f)
    sampled_features = sample_features(label_file)

    if os.path.exists(args.save_path):
        with open(args.save_path, "r") as f:
            consistency_score = json.load(f)
    else:
        consistency_score = {}

    client = OpenAIClient(model="gpt-4o", azure_endpoint=os.getenv("OPENAI_API_ENDPOINT"),
                          api_key=os.getenv("OPENAI_API_KEY"))
    save_dir = os.path.dirname(args.save_path)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    def messages(feature):
        image_folder = os.path.join(args.explanation_dir, "images", "model_layers_24", feature, "activated_images")
        images = [Image.open(p) for p in glob(os.path.join(image_folder, "*.*"))]
        content = [{"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{client.encode_images(im)}"}}
                   for im in images]
        content.append({"type": "text", "text": GPT_CONSISTENCY_PROMPT.format(label=explanation[feature])})
        return [{"role": "user", "content": content}]

    asyncio.run(judge_all(client, sampled_features, consistency_score, messages, args.save_path))


if __name__ == "__main__":
    main()
