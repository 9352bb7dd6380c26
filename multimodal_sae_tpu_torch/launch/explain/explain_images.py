"""Image feature explanation CLI (behavior of reference
launch/explain/explain_images.py:27-143): cached COO splits →
base-image-token pooled top examples with highlight composites →
ImageExplainer over a multimodal endpoint → `{module}.json` append-lists plus
per-feature images/activated_images/masks directories (the layout the CLIP
scorer reads back, reference clip_scorer.py:68-75).

Copied from multimodal_sae_tpu/launch/explain/explain_images.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import os
from functools import partial

from ...agents.explainers import ImageExplainer
from ...clients import SRT
from ...features.constructors import pool_max_activations_windows_image
from ...features.samplers import sample
from ...logger import log_to_file, logger
from ...pipeline import Pipeline, process_wrapper
from ..utils import build_feature_loader, parse_feature_experiment

EXPLAINER_MODEL = "lmms-lab/llava-onevision-qwen2-72b-ov"


def _save_feature_assets(base_dir: str, record) -> None:
    """Per-feature image/activated_image/mask dumps, top-0..k naming."""
    for sub in ("images", "activated_images", "masks"):
        os.makedirs(f"{base_dir}/{sub}", exist_ok=True)
    for rank, example in enumerate(record.train):
        example.image.save(f"{base_dir}/images/top_{rank}.png")
        example.activation_image.save(
            f"{base_dir}/activated_images/top{rank}_activated.jpg"
        )
        example.mask.save(f"{base_dir}/masks/{rank}_mask.jpg")


def main(args):
    from datasets import load_dataset
    from transformers import AutoProcessor

    logger.info("Load dataset")
    tokens = load_dataset(args.experiment.dataset, split=args.experiment.split)
    processor = AutoProcessor.from_pretrained(args.experiment.model)

    loader, modules = build_feature_loader(
        args,
        constructor=partial(
            pool_max_activations_windows_image,
            tokens=tokens,
            cfg=args.feature,
            processor=processor,
        ),
        sampler=partial(sample, cfg=args.experiment),
    )
    logger.info(f"Module list : {modules}")

    explanation_dir = os.path.expanduser(args.experiment.explanation_dir)
    os.makedirs(explanation_dir, exist_ok=True)

    logger.info("Setup server")
    client = SRT(model=EXPLAINER_MODEL, tp=8, base_url="http://localhost:12345")

    # Buffered writer: a per-result full-file rewrite is O(n^2) JSON IO
    # (same artifact format, batched flushes).
    from ._writer import ModuleRowWriter

    writer = ModuleRowWriter(explanation_dir)

    def on_result(result):
        _content, _reply, result = result
        record = result.record
        module_name = record.feature.module_name.replace(".", "_")
        writer.append(
            f"{module_name}.json", {f"{record.feature}": f"{result.explanation}"}
        )
        _save_feature_assets(
            f"{explanation_dir}/images/{module_name}/{record.feature}", record
        )
        return result

    pipeline = Pipeline(
        loader,
        process_wrapper(ImageExplainer(client=client, verbose=True), postprocess=on_result),
    )
    try:
        asyncio.run(pipeline.run(max_processes=4))
    finally:
        writer.close()
        client.clean()


if __name__ == "__main__":
    log_to_file()
    main(parse_feature_experiment())
