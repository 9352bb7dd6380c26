"""Text detection scoring CLI (behavior of reference
launch/score/score.py:26-142): sampled examples + saved explanations →
SimpleScorer (threshold 0.5, activations on) → per-feature
`{scores_dir}/{module}/{feature}.json` with {examples, scores,
max_activations} rows.

Copied from multimodal_sae_tpu/launch/score/score.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import json
import os
from functools import partial

from ...agents.scorers import SimpleScorer
from ...clients import SRT
from ...features.constructors import pool_max_activation_windows
from ...features.samplers import sample_with_explanation
from ...interp_utils import load_explanation
from ...logger import log_to_file, logger
from ...pipeline import Pipeline, process_wrapper
from ...train.data import chunk_and_tokenize
from ..utils import build_feature_loader, parse_feature_experiment

JUDGE_MODEL = "meta-llama/Meta-Llama-3.1-70B-Instruct"


def _write_feature_scores(scores_dir: str, result, messages_list) -> None:
    module_name = result.record.feature.module_name.replace(".", "_")
    os.makedirs(f"{scores_dir}/{module_name}", exist_ok=True)
    rows = [
        {
            "examples": messages,
            "scores": result.scores[i],
            "max_activations": result.max_activations[i],
        }
        for i, messages in enumerate(messages_list)
    ]
    with open(f"{scores_dir}/{module_name}/{result.record.feature}.json", "w") as f:
        json.dump(rows, f, indent=4)


def main(args):
    from datasets import load_dataset
    from transformers import AutoTokenizer

    logger.info("Load tokenizer and dataset")
    tokenizer = AutoTokenizer.from_pretrained(args.experiment.model)
    raw = load_dataset(args.experiment.dataset, split=args.experiment.split)

    logger.info(
        f"Chunking dataset into {args.feature.example_ctx_len} tokens per sample..."
    )
    tokens = chunk_and_tokenize(
        raw, tokenizer, max_seq_len=args.feature.example_ctx_len
    )["input_ids"]

    explanations = load_explanation(args.experiment.explanation_dir)

    loader, modules = build_feature_loader(
        args,
        constructor=partial(
            pool_max_activation_windows, tokens=tokens, cfg=args.feature
        ),
        sampler=partial(
            sample_with_explanation, cfg=args.experiment, explanations=explanations
        ),
    )
    logger.info(f"Module list : {modules}")

    scores_dir = os.path.expanduser(args.experiment.scores_dir)
    os.makedirs(scores_dir, exist_ok=True)

    logger.info("Setup server")
    client = SRT(model=JUDGE_MODEL, tp=8)

    def on_result(result):
        messages_list, _replies, result = result
        _write_feature_scores(scores_dir, result, messages_list)
        return result

    scorer = SimpleScorer(
        client=client,
        tokenizer=tokenizer,
        verbose=True,
        threshold=0.5,
        activations=True,
    )
    pipeline = Pipeline(loader, process_wrapper(scorer, postprocess=on_result))
    try:
        asyncio.run(pipeline.run(max_processes=4))
    finally:
        client.clean()


if __name__ == "__main__":
    log_to_file()
    main(parse_feature_experiment())
