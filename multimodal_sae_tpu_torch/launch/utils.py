"""Launch-script plumbing (multimodal_sae_tpu/launch/utils.py): subject
loading from a local HF checkpoint with its generation config, the chat
prompt batch, datasets, hookpoint checks, and the cached-feature loader of
the explain, score and image tools.
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
    load_in_8bit: bool = False,
    int8_matmul: bool = False,
    int8_vision: bool = False,
    tp: int = 0,
    dp: int = 0,
    remat: bool = False,
) -> Tuple[object, Optional[object], object]:
    """The frozen subject from a local HF checkpoint directory: LLaVA-NeXT
    when the checkpoint is one (config.json's model_type, else the name),
    plain LLaMA otherwise.  Returns (model, processor or None, tokenizer).
    `truncate_layers` > 0 keeps only the first N language-model layers, whose
    weights alone reach the device; hookpoints below N are unchanged.  The
    model carries the checkpoint's `generation_config` (a dict, see
    `_load_generation_config`), which its `generate` reads stop ids from.

    `load_in_8bit` quantises the subject to int8 (models/quant.py), the
    language model and, for LLaVA-NeXT, the CLIP tower too (the reference
    quantises the whole model, JAX launch/utils.py:148-158); it computes in
    bf16 with W8A16 products.  `int8_matmul` implies it and runs the
    language model's products W8A8; `int8_vision` runs the quantised
    tower's W8A8.  The weights are quantised after the truncation, leaf by
    leaf as they move from the host to the device, so the dropped layers
    never reach it and the dense and the int8 tree are never both whole on
    it.

    `remat` recomputes the language model's decoder layers in the backward
    (`LlamaConfig.remat`).  Each runtime flag is OR-ed into the language
    model's config by `_merge_flags`, on both branches.

    `tp > 1` shards the language model over this rank's TP group of a
    torchrun world that `tp` divides (parallel/tensor_parallel.py): the
    weights are read and quantised on the host, and only this rank's slices
    reach its card.  `dp > 1` copies the subject onto the first `dp` CUDA
    devices (parallel/data_parallel.py).  The two are exclusive in one
    process, as in the JAX package."""
    if tp and tp > 1 and dp and dp > 1:
        raise ValueError(
            "--tp and --dp are mutually exclusive within one process; "
            "compose them as multi-process data parallelism over TP "
            "subjects (docs/DISTRIBUTED.md)"
        )
    from transformers import AutoTokenizer

    from ..device import resolve_device
    from ..models.quant import quantize_clip_params, quantize_llama_params

    dev = resolve_device(device)
    quantize = load_in_8bit or int8_matmul
    sharded = bool(tp and tp > 1)
    load_dev = torch.device("cpu") if quantize or sharded else dev
    quant_dev = torch.device("cpu") if sharded else dev
    if _is_llava_checkpoint(model_name_or_path):
        from transformers import LlavaNextProcessor

        from ..models.llava_next import LlavaNextModel, load_llava_next

        params, cfg = load_llava_next(
            model_name_or_path, dtype=dtype, device=load_dev, truncate_layers=truncate_layers
        )
        if quantize:
            quantize_llama_params(params["language_model"], device=quant_dev)
            quantize_clip_params(params["vision_tower"], device=quant_dev)
            params["projector"] = {name: t.to(quant_dev) for name, t in params["projector"].items()}
            params["image_newline"] = params["image_newline"].to(quant_dev)
        text_cfg = _merge_flags(cfg.text_config, flash_attention, int8_matmul, remat)
        vision_cfg = dataclasses.replace(cfg.vision_config, int8_matmul=int8_vision or cfg.vision_config.int8_matmul)
        model = LlavaNextModel(params, dataclasses.replace(cfg, text_config=text_cfg, vision_config=vision_cfg))
        processor = LlavaNextProcessor.from_pretrained(model_name_or_path, token=hf_token)
    else:
        from ..models.hf_loader import load_llama
        from ..models.llama import LlamaModel

        params, cfg = load_llama(
            model_name_or_path, dtype=dtype, device=load_dev, truncate_layers=truncate_layers
        )
        if quantize:
            quantize_llama_params(params, device=quant_dev)
        cfg = _merge_flags(cfg, flash_attention, int8_matmul, remat)
        model, processor = LlamaModel(params, cfg), None
    if sharded:
        from ..parallel import shard_subject_model

        shard_subject_model(model, tp, device=dev)
    elif dp and dp > 1:
        from ..parallel import shard_subject_model_dp

        shard_subject_model_dp(model, dp)
    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, token=hf_token)
    model.generation_config = _load_generation_config(model_name_or_path)
    return model, processor, tokenizer


def _merge_flags(text_cfg, flash_attention: bool, int8_matmul: bool, remat: bool):
    """The language model's config with the runtime flags OR-ed into it
    (JAX launch/utils.py:107-116: one merge for the LLaVA and the plain
    LLaMA branch, so that no flag reaches one and misses the other)."""
    return dataclasses.replace(
        text_cfg,
        flash_attention=flash_attention or text_cfg.flash_attention,
        int8_matmul=int8_matmul or text_cfg.int8_matmul,
        remat=remat or text_cfg.remat,
    )


def _load_generation_config(model_name_or_path: str) -> dict:
    """Sampling knobs from the checkpoint's generation_config.json (the
    reference inherits these through HF `generate`); a missing file gives
    {} (greedy)."""
    path = os.path.join(model_name_or_path, "generation_config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        raw = json.load(f)
    return {k: raw[k] for k in ("do_sample", "temperature", "top_p", "eos_token_id") if raw.get(k) is not None}


def prepare_prompt_batch(
    model,
    processor,
    tokenizer,
    text: Optional[str],
    image=None,
    use_chat_template: bool = True,
    raw_prompt: Optional[str] = None,
):
    """(tok, prompt_ids, batch) of one prompt: the text (and an optional
    image) chat-templated through the processor, or the tokenizer for a
    text-only subject, tokenized, and prepared with the image when there is
    one.  With `use_chat_template=False`, `raw_prompt` is tokenized as it
    is."""
    if use_chat_template:
        conversation = [{"role": "user", "content": [{"type": "text", "text": text}]}]
        if image is not None:
            conversation[0]["content"].append({"type": "image"})
        templater = processor if processor is not None else tokenizer
        prompt = templater.apply_chat_template(conversation, add_generation_prompt=True, tokenize=False)
    else:
        prompt = raw_prompt
    tok = getattr(processor, "tokenizer", tokenizer)
    prompt_ids = tok(prompt)["input_ids"]
    if image is not None:
        batch = model.prepare_inputs(images=[image], prompt_ids=[prompt_ids])
    else:
        batch = {"input_ids": [prompt_ids]}
    return tok, prompt_ids, batch


def load_subject_or_synthetic(cfg, device: DeviceLike = None):
    """`synthetic://dM,L,V` builds the synthetic subject; anything else is a
    local checkpoint through `load_subject_model`.  Refuses `--tp` / `--dp`
    on a synthetic subject, which has no checkpoint weights to shard or
    copy."""
    if cfg.model.startswith("synthetic://"):
        parallel = [f"--{name} {getattr(cfg, name)}" for name in ("tp", "dp") if (getattr(cfg, name, 0) or 0) > 1]
        if parallel:
            raise ValueError(f"{' and '.join(parallel)} shard or copy a checkpoint subject; {cfg.model} is synthetic")
        from ..models import SyntheticActivationSource

        return SyntheticActivationSource.from_spec(cfg.model, device=device), None, None
    return load_subject_model(
        cfg.model,
        flash_attention=cfg.flash_attention,
        hf_token=cfg.hf_token,
        truncate_layers=cfg.truncate_layers,
        device=device,
        load_in_8bit=cfg.load_in_8bit,
        int8_matmul=cfg.int8_matmul,
        int8_vision=getattr(cfg, "int8_vision", False),
        tp=getattr(cfg, "tp", 0),
        dp=getattr(cfg, "dp", 0),
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
    """(shard, shards) of the launch flows' rows: (rank, world) in the
    process group, (0, 1) when none is up, and under `--tp` the
    data-parallel index and count (`rank // tp`, `world // tp`), which every
    rank of a TP group shares."""
    from ..parallel.tensor_parallel import current_layout
    from ..utils.misc import process_count, process_index

    layout = current_layout()
    if layout is not None:
        return layout.dp_index, layout.dp_size
    return process_index(), process_count()


def writes_outputs() -> bool:
    """Whether this rank writes the launch flows' files: every rank, each
    its own shard, except under `--tp`, where a TP group's first rank
    writes for the group."""
    from ..parallel.tensor_parallel import current_layout

    layout = current_layout()
    return layout is None or layout.writes_outputs


def infer_n_splits(activation_dir: str, module: str) -> int:
    """The number of merged `{start}_{end}.safetensors` splits in a cache's
    module directory: the value every reader must agree on with the writer,
    so that a CLI defaults to the cache's own layout."""
    import re

    d = os.path.join(activation_dir, module)
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"no '{module}' module dir under {activation_dir}: cannot infer --n-splits; check "
            "--selected-layer and the cache path"
        )
    n = len([f for f in os.listdir(d) if re.fullmatch(r"\d+_\d+\.safetensors", f)])
    if n == 0:
        raise FileNotFoundError(
            f"no merged '<start>_<end>.safetensors' splits in {d}: was the cache merged "
            "(concate_safetensors)? Unmerged Rank* shards cannot be scored"
        )
    return n


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
