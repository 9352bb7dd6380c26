"""Launch-script plumbing (multimodal_sae_tpu/launch/utils.py): subject
loading from a local HF checkpoint, datasets, hookpoint checks, and the
cached-feature loader of the explain, score and image tools.
`transformers` and `datasets` are imported only inside the helpers that need
a tokenizer, a processor or an HF dataset."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from ..device import DeviceLike

_UNPORTED = {
    "load_in_8bit": "§1, int8 quantisation",
    "int8_matmul": "§1, int8 quantisation",
    "int8_vision": "§1, int8 quantisation",
    "sae_int8": "§1, int8 quantisation",
    "tp": "§1, multi-process and tensor parallelism",
    "dp": "§1, multi-process and tensor parallelism",
}


def _is_llava_checkpoint(model_name_or_path: str) -> bool:
    cfg_file = os.path.join(model_name_or_path, "config.json")
    if os.path.isdir(model_name_or_path) and os.path.isfile(cfg_file):
        with open(cfg_file) as f:
            return "llava" in json.load(f).get("model_type", "")
    return "llava" in model_name_or_path


def load_subject_model(
    model_name_or_path: str,
    dtype: torch.dtype = torch.bfloat16,
    flash_attention: bool = False,
    hf_token: Optional[str] = None,
    truncate_layers: int = 0,
    device: DeviceLike = None,
) -> Tuple[object, Optional[object], object]:
    """The frozen subject from a local HF checkpoint directory: LLaVA-NeXT
    when the checkpoint is one (config.json's model_type, else the name),
    plain LLaMA otherwise.  Returns (model, processor or None, tokenizer).
    `truncate_layers` > 0 keeps only the first N language-model layers, whose
    weights alone reach the device; hookpoints below N are unchanged."""
    from transformers import AutoTokenizer

    if _is_llava_checkpoint(model_name_or_path):
        from transformers import LlavaNextProcessor

        from ..models.llava_next import LlavaNextModel, load_llava_next

        params, cfg = load_llava_next(
            model_name_or_path, dtype=dtype, device=device, truncate_layers=truncate_layers
        )
        text_cfg = dataclasses.replace(
            cfg.text_config, flash_attention=flash_attention or cfg.text_config.flash_attention
        )
        model = LlavaNextModel(params, dataclasses.replace(cfg, text_config=text_cfg))
        processor = LlavaNextProcessor.from_pretrained(model_name_or_path, token=hf_token)
    else:
        from ..models.hf_loader import load_llama
        from ..models.llama import LlamaModel

        params, cfg = load_llama(
            model_name_or_path, dtype=dtype, device=device, truncate_layers=truncate_layers
        )
        cfg = dataclasses.replace(cfg, flash_attention=flash_attention or cfg.flash_attention)
        model, processor = LlamaModel(params, cfg), None
    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, token=hf_token)
    return model, processor, tokenizer


def refuse_unported(cfg) -> None:
    """Raise on a CLI option whose path a later slice ports."""
    for name, item in _UNPORTED.items():
        value = getattr(cfg, name, False)
        if value is True or (not isinstance(value, bool) and value > 1):
            raise NotImplementedError(f"--{name} is not ported yet: ROADMAP.md {item}")


def load_subject_or_synthetic(cfg, device: DeviceLike = None):
    """`synthetic://dM,L,V` builds the synthetic subject; anything else is a
    local checkpoint through `load_subject_model`.  Refuses the options
    whose paths later slices port."""
    refuse_unported(cfg)
    if cfg.model.startswith("synthetic://"):
        from ..models import SyntheticActivationSource

        return SyntheticActivationSource.from_spec(cfg.model, device=device), None, None
    return load_subject_model(
        cfg.model,
        flash_attention=cfg.flash_attention,
        hf_token=cfg.hf_token,
        truncate_layers=cfg.truncate_layers,
        device=device,
    )


def load_any_dataset(name_or_path: str, split: str = "train"):
    """A local `Dataset.save_to_disk` directory, or an HF hub dataset."""
    from datasets import Dataset, load_dataset

    if os.path.isdir(name_or_path) and os.path.exists(os.path.join(name_or_path, "state.json")):
        return Dataset.load_from_disk(name_or_path)
    return load_dataset(name_or_path, split=split, trust_remote_code=True)


def validate_hookpoints(model, hookpoints) -> None:
    """Fail fast on a hookpoint the subject does not have (wrong prefix, a
    layer past its depth, or one dropped by --truncate_layers)."""
    available = model.hookpoint_names()
    missing = [h for h in hookpoints if h not in set(available)]
    if missing:
        raise ValueError(
            f"hookpoint(s) {missing} not present on the subject model "
            f"(it exposes {available[0]} .. {available[-1]}; "
            f"--truncate_layers drops layers from the top)"
        )


def shard_info() -> Tuple[int, int]:
    """(rank, world): one process until multi-process runs are ported."""
    return 0, 1


def parse_feature_experiment(argv=None):
    """Parse FeatureConfig + ExperimentConfig from one flag namespace;
    returns an object with `.feature` and `.experiment`."""
    from ..config import ExperimentConfig, FeatureConfig
    from ..utils.cli import add_dataclass_args, dataclass_from_namespace

    parser = argparse.ArgumentParser()
    add_dataclass_args(parser, FeatureConfig)
    add_dataclass_args(parser, ExperimentConfig)
    ns = parser.parse_args(argv)
    return argparse.Namespace(
        feature=dataclass_from_namespace(FeatureConfig, ns),
        experiment=dataclass_from_namespace(ExperimentConfig, ns),
    )


def select_modules(save_dir: str, filters, selected_layers):
    """The module directories of a cache, natsorted (layers.5 < layers.10),
    narrowed to the filter's keys, else to the selected layer positions."""
    from ..utils import natsorted

    modules = natsorted(os.listdir(save_dir))
    if filters is not None:
        return [m for m in modules if m in filters]
    if selected_layers:
        return [m for i, m in enumerate(modules) if i in selected_layers]
    return modules


def build_feature_loader(args, constructor, sampler=None):
    """A `FeatureDataset` over `args.experiment.save_dir` (filtered by
    `filters_path` when given) and its `load` with the already-bound
    `constructor(record, buffer_output)` and `sampler(record)`.  Returns
    (loader, modules)."""
    from functools import partial

    from ..features import FeatureDataset
    from ..interp_utils import load_filter

    filters = load_filter(args.experiment.filters_path) if args.experiment.filters_path is not None else None
    modules = select_modules(args.experiment.save_dir, filters, args.experiment.selected_layers)
    dataset = FeatureDataset(raw_dir=args.experiment.save_dir, cfg=args.feature, modules=modules, features=filters)
    loader = partial(dataset.load, constructor=constructor, sampler=sampler)
    return loader, modules
