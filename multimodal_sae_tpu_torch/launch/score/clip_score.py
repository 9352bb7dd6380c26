"""CLIP-Score CLI (behavior of reference launch/score/clip_score.py:13-89):
optionally label-refine the explanations (or reuse a refine cache), score
each feature's example/random/generated images against its label, save json.

Copied from multimodal_sae_tpu/launch/score/clip_score.py; it uses no jax.
"""

from __future__ import annotations

import argparse
import json
import os

from ...agents.scorers import ClipScorer, GeneratedClipScorer, LabelRefiner
from ...clients import SRT

REFINER_MODEL = "meta-llama/Llama-3.1-8B-Instruct"


def build_scorer(args):
    common = dict(
        explanation_dir=args.explanation_dir,
        dataset_path=args.dataset_path,
        dataset_split=args.dataset_split,
        k=5,
        clip_model_name_or_path=args.clip_name_or_path,
    )
    if args.evaluation_type == "generated":
        return GeneratedClipScorer(evaluation_type="default", **common)
    return ClipScorer(evaluation_type=args.evaluation_type, **common)


def ensure_refined(scorer, args):
    if args.refine_cache is not None:
        scorer.explanations = json.load(open(args.refine_cache, "r"))
        return
    client = SRT(model=REFINER_MODEL, tp=2)
    try:
        scorer.refine(
            LabelRefiner(client, scorer.explanations), save_path=args.save_refine_path
        )
    finally:
        client.clean()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-path", "-d", type=str, help="The dataset you use")
    parser.add_argument("--dataset-split", type=str, default="train")
    parser.add_argument(
        "--clip_name_or_path", type=str, default="openai/clip-vit-base-patch32"
    )
    parser.add_argument("--refine-cache", type=str, default=None)
    parser.add_argument("--save-refine-path", type=str)
    parser.add_argument("--explanation_dir", type=str)
    parser.add_argument("--save-score-path", type=str, required=True)
    parser.add_argument(
        "--evaluation_type",
        "-e",
        type=str,
        default="default",
        choices=["default", "random", "generated"],
    )
    args = parser.parse_args()
    if args.refine_cache is None and args.save_refine_path is None:
        # Fail at parse time, not after the refine LLM pass has run.
        parser.error("--save-refine-path is required when no --refine-cache is given")

    scorer = build_scorer(args)
    ensure_refined(scorer, args)
    scores = scorer.run()

    parent = os.path.dirname(args.save_score_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(args.save_score_path, "w") as f:
        json.dump(scores, f, indent=4)


if __name__ == "__main__":
    main()
