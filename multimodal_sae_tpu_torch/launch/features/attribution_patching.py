"""Attribution-patching CLI:

    python -m multimodal_sae_tpu_torch.launch.features.attribution_patching <model> \\
        --data_path <probe.json> --sae_path <dir or org/name> --selected_sae model.layers.24 \\
        [--flash_attention] [--feature_batch N] [--save_dir DIR]

The flags of `python -m multimodal_sae_tpu.launch.features.attribution_patching`
(reference launch/features/attribution_patching.py:15-80): the
grad x activation saliency of every feature of the selected SAE over the
probe rows, written as one `{model}_{selected_sae with . as _}.safetensors`
file under `--save_dir` whose key `{selected_sae}` holds the
(num_features * B, S) float32 maps, the layout
`tools/create_filters_from_attribution.py` reads.  The subject (a local
checkpoint directory, in bf16) and the SAE run on the CUDA card; one SAE
on a subject with `forward_from_layer` (LLaMA or LLaVA-NeXT) takes the
prefix/suffix path.  Under `torchrun --nproc_per_node N` each rank
attributes its `np.array_split` share of the features on its card, and
rank 0 writes the one merged file (`gather_and_merge`).
`--load_in_8bit`, `--int8_matmul` and `--int8_vision` quantise the subject
(models/quant.py); the backward flows through the quantised products'
straight-through gradient to the splice.  `--tp N` shards the subject over
each group of N consecutive ranks (the features are split over the groups,
and the backward runs through the group's collectives); `--dp N` splits
each feature chunk over N copies of the subject in one process
(parallel/).  `--remat` recomputes the subject's decoder layers in the
backward (`LlamaConfig.remat`), so that the suffix's tape keeps only the
layers' inputs."""

from __future__ import annotations

import os

import numpy as np
import torch

from ...config import AttributionConfig
from ...device import DeviceLike, setup
from ...features.patching import Attribution
from ...logger import logger
from ...parallel import all_gather_objects, initialize_distributed, process_index
from ...parallel.tensor_parallel import replicate_saes
from ...utils.cli import parse_dataclass
from ...utils.safetensors_io import save_file
from ..utils import load_subject_model, shard_info, validate_hookpoints, writes_outputs


def gather_and_merge(local: dict):
    """Every rank's {key: (n_local_features * B, S)} maps gathered in rank
    order and concatenated on rank 0, which is the global feature order of
    the `np.array_split` shards; None on the other ranks (JAX
    launch/features/attribution_patching.py:29-48, reference
    all_gather_object and rank-0 save, :50-75).  Under `--tp` the ranks of
    a TP group hold the same maps: the group's first rank's are kept, and
    the global rank 0 writes."""
    per_rank = all_gather_objects((writes_outputs(), local))
    if process_index() != 0:
        return None
    merged = {}
    for writer, part in per_rank:
        if not writer:
            continue
        for key, arr in part.items():
            merged[key] = arr if key not in merged else np.concatenate([merged[key], arr], axis=0)
    return merged


def main(cfg: AttributionConfig, device: DeviceLike = None):
    """Attribute, gather and (on rank 0) write; returns the written file's
    path on rank 0 and None elsewhere."""
    device = setup(device)
    initialize_distributed(device)

    logger.info(f"Using model {cfg.model}")
    logger.info(f"Using sae {cfg.sae_path}")
    logger.info(f"Selecting sae layer {cfg.selected_sae}")

    model, _processor, tokenizer = load_subject_model(
        cfg.model, dtype=torch.bfloat16, flash_attention=cfg.flash_attention, device=device,
        load_in_8bit=cfg.load_in_8bit, int8_matmul=cfg.int8_matmul, int8_vision=cfg.int8_vision,
        tp=cfg.tp, dp=cfg.dp, remat=cfg.remat,
    )
    rank, world = shard_info()
    attribution = Attribution(
        model,
        tokenizer,
        sae_path=cfg.sae_path,
        data_path=cfg.data_path,
        selected_sae=cfg.selected_sae,
        feature_batch=cfg.feature_batch,
        device=device,
    )
    replicate_saes(model, attribution.sae_dict.values())
    # A hookpoint the subject does not expose fails here, not inside the
    # capture or the suffix.
    validate_hookpoints(model, list(attribution.sae_dict))

    saes = list(attribution.sae_dict.values())
    k = saes[0].cfg.num_latents_for(saes[0].d_in)
    indices = np.array_split(np.arange(k), world)[rank]

    attribution_dict = attribution.get_attribution(indices)

    logger.info("Save results")
    merged = gather_and_merge({key: np.concatenate(v, axis=0) for key, v in attribution_dict.items()})
    if merged is None:
        return None
    os.makedirs(cfg.save_dir, exist_ok=True)
    output_file = os.path.join(
        cfg.save_dir, f"{cfg.model.split('/')[-1]}_{cfg.selected_sae.replace('.', '_')}.safetensors"
    )
    logger.info(output_file)
    save_file(merged, output_file)
    return output_file


if __name__ == "__main__":
    main(parse_dataclass(AttributionConfig))
