"""CLIP-Score evaluation (reference agents/scorers/clip/clip_scorer.py:18-165):
score = max(0, 100 * cosine(image_emb, text_emb)) between each refined
explanation and its feature's top example images (default), random images
(baseline, 30 runs), or generated images (GeneratedClipScorer).

The reference computes the metric with torchmetrics' CLIPScore on GPU; here
the metric is injectable: pass `metric=fn(pil_image, text) -> float` (tests
inject a stub; a torchmetrics-backed default is constructed when available).
Score-dict schema matches the reference exactly.  PIL is imported where an
image is opened (the card's machine has none).  `models.clip_full.clip_metric`
is a metric whose CLIP runs on the card.

Copied from multimodal_sae_tpu/agents/scorers/clip/clip_scorer.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import os
from glob import glob
from typing import TYPE_CHECKING, Callable, Literal, Optional

import numpy as np

from ....interp_utils import load_explanation
from ....utils import natsorted
from ..segment.label_refiner import LabelRefiner

if TYPE_CHECKING:
    from PIL import Image


def torchmetrics_clip_metric(model_name: str, device: str = "cpu"):
    """Default metric backend (reference clip_scorer.py:32)."""
    import torch
    from torchmetrics.multimodal.clip_score import CLIPScore

    metric = CLIPScore(model_name).to(device)

    def fn(image: Image.Image, text: str) -> float:
        tensor = torch.tensor(np.asarray(image)).permute(2, 0, 1)
        return float(metric(tensor.to(device), text).detach().cpu().item())

    return fn


class ClipScorer:
    def __init__(
        self,
        explanation_dir: str,
        dataset_path: str,
        dataset_split: str = "train",
        k: int = 5,
        evaluation_type: Literal["random", "default"] = "default",
        clip_model_name_or_path: str = "openai/clip-vit-base-patch16",
        device: str = "cpu",
        random_runs: int = 30,
        metric: Optional[Callable[[Image.Image, str], float]] = None,
        dataset=None,
        seed: Optional[int] = None,
    ) -> None:
        self.clip_model_name_or_path = clip_model_name_or_path
        self.device = device
        if metric is None:
            metric = torchmetrics_clip_metric(clip_model_name_or_path, device)
        self.metric = metric
        self.explanation_dir = explanation_dir
        self.explanations = load_explanation(explanation_dir)
        self.dataset_path = dataset_path
        if dataset is None and dataset_path:
            from datasets import load_dataset

            dataset = load_dataset(dataset_path, split=dataset_split)
        self.dataset = dataset
        self.features = natsorted(self.explanations.keys())
        self.eval_type = evaluation_type
        self.k = k
        self.random_runs = random_runs
        self._rng = np.random.default_rng(seed)

    def refine(self, refiner: LabelRefiner, save_path):
        asyncio.run(refiner.refine())
        self.explanations = refiner.refine_features
        refiner.save_result(save_path)

    def _images_for(self, feature: str):
        if self.eval_type == "default":
            # Saved per-feature example images
            # (layout written by launch.explain.explain_images, reference
            # explain_images.py:101-114).
            model_layer = feature.split("_")[0].replace(".", "_")
            image_folder = os.path.join(
                self.explanation_dir, "images", model_layer, feature, "images"
            )
            image_files = natsorted(glob(os.path.join(image_folder, "*.*")))
            from PIL import Image

            return [Image.open(im).convert("RGB") for im in image_files]
        elif self.eval_type == "random":
            final_idx = []
            for _ in range(self.random_runs):
                select_idx = self._rng.permutation(len(self.dataset))[: self.k].tolist()
                final_idx.extend(select_idx)
            return [
                im.convert("RGB") for im in self.dataset.select(final_idx)["image"]
            ]
        raise ValueError(self.eval_type)

    def run(self):
        self.scores = []
        try:
            from tqdm import tqdm

            pbar = tqdm(total=len(self.features), desc="Perform scoring")
        except ImportError:
            pbar = None
        for feature in self.features:
            if "Unable to produce descriptions" in self.explanations[feature]:
                self.scores.append(
                    {
                        "feature": feature,
                        "clip_scores": [],
                        "avg_score": -1,
                        "k": -1,
                        "label": self.explanations[feature],
                    }
                )
                if pbar:
                    pbar.update(1)
                continue
            images = self._images_for(feature)
            scores = [
                self.metric(image, self.explanations[feature]) for image in images
            ]
            if pbar:
                pbar.update(1)
            self.scores.append(
                {
                    "feature": feature,
                    "clip_scores": scores,
                    "avg_score": sum(scores) / len(scores) if scores else -1,
                    "k": len(scores),
                    "label": self.explanations[feature],
                }
            )
        if pbar:
            pbar.close()
        return self.scores


class GeneratedClipScorer(ClipScorer):
    """Scores generated images keyed by feature (reference clip_scorer.py:114-165):
    the dataset holds {"feature", "image"} rows (e.g. FLUX generations)."""

    def __init__(self, *args, k: int = 1, **kwargs):
        super().__init__(*args, k=k, **kwargs)

    def run(self):
        self.scores = []
        for doc in self.dataset:
            feature = doc["feature"]
            image = doc["image"]
            clip_score = self.metric(image.convert("RGB"), self.explanations[feature])
            self.scores.append(
                {
                    "feature": feature,
                    "clip_scores": clip_score,
                    "avg_score": clip_score,
                    "k": 1,
                    "label": self.explanations[feature],
                }
            )
        return self.scores
