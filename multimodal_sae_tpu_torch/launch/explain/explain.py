"""Text feature explanation CLI (behavior of reference
launch/explain/explain.py:23-127): cached COO splits → max-pooled example
windows → SimpleExplainer over an OpenAI-compatible endpoint → append
{feature: explanation, prompt} rows to `{module}.json`.

Copied from multimodal_sae_tpu/launch/explain/explain.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import os
from functools import partial

from ...agents.explainers import SimpleExplainer
from ...clients import SRT
from ...features.constructors import pool_max_activation_windows
from ...features.samplers import sample
from ...logger import log_to_file, logger
from ...pipeline import Pipeline, process_wrapper
from ...train.data import chunk_and_tokenize
from ..utils import build_feature_loader, parse_feature_experiment


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

    loader, modules = build_feature_loader(
        args,
        constructor=partial(
            pool_max_activation_windows, tokens=tokens, cfg=args.feature
        ),
        sampler=partial(sample, cfg=args.experiment),
    )
    logger.info(f"Module list : {modules}")

    explanation_dir = os.path.expanduser(args.experiment.explanation_dir)
    os.makedirs(explanation_dir, exist_ok=True)

    logger.info("Setup server")
    client = SRT(model=args.experiment.explainer, tp=8)

    # Buffered writer: a per-result full-file rewrite is O(n^2) JSON IO
    # over the run (same artifact format, batched flushes).
    from ._writer import ModuleRowWriter

    writer = ModuleRowWriter(explanation_dir)

    def on_result(result):
        content, _reply, result = result
        module_name = result.record.feature.module_name.replace(".", "_")
        writer.append(
            f"{module_name}.json",
            {f"{result.record.feature}": f"{result.explanation}", "prompt": content},
        )
        return result

    explainer = SimpleExplainer(
        client=client, tokenizer=tokenizer, verbose=True, activations=True
    )
    pipeline = Pipeline(loader, process_wrapper(explainer, postprocess=on_result))
    try:
        asyncio.run(pipeline.run(max_processes=4))
    finally:
        # Always reap the spawned serving subprocess, even when the
        # pipeline raises (it holds every accelerator at tp=8) — and land
        # any buffered rows first.
        writer.close()
        client.clean()


if __name__ == "__main__":
    log_to_file()
    main(parse_feature_experiment())
