"""Regenerate example/activated images for already-explained features
(behavior of reference launch/features/image_activations.py:25-100).

Copied from multimodal_sae_tpu/launch/features/image_activations.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import os
from functools import partial

from ...features.constructors import pool_max_activations_windows_image
from ...features.features import FeatureRecord
from ...features.samplers import sample_with_explanation
from ...interp_utils import load_explanation
from ...logger import log_to_file, logger
from ...pipeline import Pipeline
from ..utils import build_feature_loader, parse_feature_experiment


async def image_saver(record: FeatureRecord, save_dir: str):
    feature_dir = os.path.join(
        save_dir, record.feature.module_name.replace(".", "_"), f"{record.feature}"
    )
    os.makedirs(feature_dir, exist_ok=True)
    for rank, example in enumerate(record.examples):
        example.image.save(os.path.join(feature_dir, f"examples_{rank}.jpg"))
        example.activation_image.save(
            os.path.join(feature_dir, f"activated_examples_{rank}.jpg")
        )


def main(args):
    from datasets import load_dataset
    from transformers import AutoProcessor

    logger.info("Load dataset")
    tokens = load_dataset(args.experiment.dataset, split=args.experiment.split)
    processor = AutoProcessor.from_pretrained(args.experiment.model)

    explanations = load_explanation(args.experiment.explanation_dir)

    loader, modules = build_feature_loader(
        args,
        constructor=partial(
            pool_max_activations_windows_image,
            tokens=tokens,
            cfg=args.feature,
            processor=processor,
        ),
        sampler=partial(
            sample_with_explanation, cfg=args.experiment, explanations=explanations
        ),
    )
    logger.info(f"Module list : {modules}")

    save_dir = os.path.join(args.experiment.explanation_dir, "images")
    os.makedirs(save_dir, exist_ok=True)

    pipeline = Pipeline(loader, partial(image_saver, save_dir=save_dir))
    asyncio.run(pipeline.run(max_processes=4))


if __name__ == "__main__":
    log_to_file()
    main(parse_feature_experiment())
