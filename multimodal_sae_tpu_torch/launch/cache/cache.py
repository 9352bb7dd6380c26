"""Text activation caching CLI:

    python -m multimodal_sae_tpu_torch.launch.cache.cache <model> <dataset> \\
        --sae_path <dir or org/name> [--flash_attention] [--truncate_layers N] ...
    torchrun --nproc_per_node N -m multimodal_sae_tpu_torch.launch.cache.cache ...

The same flags as `python -m multimodal_sae_tpu.launch.cache.cache`
(reference launch/cache/cache.py:19-103).  The subject (`synthetic://dM,L,V`
or a local plain-LLaMA checkpoint directory) and the SAEs run on the CUDA
card.  An `--sae_path` that is not a local path names a HuggingFace
repository (`interp_utils.load_saes`), which `HF_HUB_OFFLINE=1` reads from
the HuggingFace cache with no network; under torchrun each rank drives one card, caches a contiguous shard
of the dataset into its own `Rank{r}_*` splits, and rank 0 merges them
after a barrier.  `--load_in_8bit` and `--int8_matmul` quantise the
subject (models/quant.py), `--sae_int8` the SAE encoders (W8A8).
`--tp N` under `torchrun --nproc_per_node M` (M a multiple of N) shards
the subject over each group of N consecutive ranks
(parallel/tensor_parallel.py): the rows are sharded over the M / N groups,
and each group's first rank writes its splits.  `--dp N` copies the subject
onto the first N cards of one process and feeds N x batch_size rows a step
(parallel/data_parallel.py), so its cache equals a one-card run at that
batch size byte for byte."""

from __future__ import annotations

import time
from typing import Callable, Dict

from ...config import CacheConfig
from ...device import DeviceLike, setup
from ...features import FeatureCache, FeatureImageCache
from ...features.cache import _batched
from ...interp_utils import load_filter, load_saes
from ...logger import logger
from ...parallel import barrier, initialize_distributed, shard_dataset_contiguous
from ...train.data import chunk_and_tokenize
from ...utils.cli import parse_dataclass
from ...utils.profiling import maybe_trace
from ...parallel.tensor_parallel import replicate_saes
from ..utils import load_any_dataset, load_subject_or_synthetic, shard_info, validate_hookpoints, writes_outputs


def run_cache(
    cfg: CacheConfig,
    capture_fn: Callable,
    submodule_dict: Dict,
    dataset,
    filters=None,
    cache_cls=FeatureCache,
) -> Dict[str, float]:
    """The caching flow on a loaded subject (`capture_fn`), SAEs and dataset
    (JAX launch/cache/cache.py:22-84): this rank's contiguous shard of the
    rows at its global offset, streamed into `Rank{rank}_*` splits; a
    barrier, so every rank's splits exist before rank 0 merges them into
    `{start}_{end}.safetensors` with their `.featidx` sidecars; and a
    barrier, so no rank leaves before the merge lands.  Returns the seconds
    of each step ("run", "save", "barrier_save", "merge" (rank 0),
    "barrier_merge").

    The shard is `shard_info()`'s, the data-parallel index under `--tp`;
    there the other ranks of a TP group only capture, the same batches in
    the same order, since every capture is a collective of the group.  A
    step takes `batch_size * dp` rows (`--dp`, JAX cache.py:60-64).

    It runs inside `maybe_trace("cache")` (`"cache_image"` for the image
    cache): with `MMSAE_PROFILE_DIR` set, the profile and the `cache.*`
    span totals land in `$MMSAE_PROFILE_DIR/<name>/rank{r}.*.json`."""
    with maybe_trace("cache_image" if issubclass(cache_cls, FeatureImageCache) else "cache"):
        return _run_cache(cfg, capture_fn, submodule_dict, dataset, filters, cache_cls)


def _run_cache(cfg, capture_fn, submodule_dict, dataset, filters, cache_cls) -> Dict[str, float]:
    rank, world = shard_info()
    dataset, shard_start = shard_dataset_contiguous(dataset, world, rank)
    dp = max(1, getattr(cfg, "dp", 0))
    batch_size = cfg.batch_size * dp
    writer = writes_outputs()
    cache = cache_cls(capture_fn, submodule_dict, batch_size=batch_size, shard_size=shard_start, filters=filters)
    if writer:
        cache.enable_streaming(cfg.save_dir, cfg.n_splits, rank=rank)
    t0 = time.perf_counter()
    if writer:
        cache.run(cfg.ctx_len, dataset)
    else:
        for batch in _batched(dataset, batch_size):
            capture_fn(batch)
    t1 = time.perf_counter()
    if writer:
        cache.save_splits(n_splits=cfg.n_splits, save_dir=cfg.save_dir, rank=rank)
    t2 = time.perf_counter()
    barrier("cache_save_splits")
    t3 = time.perf_counter()
    if rank == 0 and writer:
        cache.concate_safetensors(n_splits=cfg.n_splits, save_dir=cfg.save_dir)
    t4 = time.perf_counter()
    barrier("cache_merge_done")
    seconds = dict(run=t1 - t0, save=t2 - t1, barrier_save=t3 - t2, merge=t4 - t3,
                   barrier_merge=time.perf_counter() - t4)
    logger.info(f"rank {rank} of {world}: {seconds}")
    return seconds


def load(cfg: CacheConfig, device: DeviceLike = None):
    """(subject, tokenized dataset, {hookpoint: Sae}, filters or None)."""
    model, _, tokenizer = load_subject_or_synthetic(cfg, device=device)
    dataset = load_any_dataset(cfg.dataset, cfg.split)
    if "input_ids" not in dataset.column_names:
        if tokenizer is None:
            raise ValueError("a synthetic subject needs a tokenized dataset")
        dataset = chunk_and_tokenize(dataset, tokenizer, max_seq_len=cfg.ctx_len)
    filters = load_filter(cfg.filters_path) if cfg.filters_path is not None else None
    submodule_dict = load_saes(cfg.sae_path, filters=filters, device=device, int8_encoder=cfg.sae_int8)
    replicate_saes(model, submodule_dict.values())
    validate_hookpoints(model, list(submodule_dict))
    return model, dataset, submodule_dict, filters


def main(cfg: CacheConfig, device: DeviceLike = None):
    device = setup(device)
    initialize_distributed(device)
    model, dataset, submodule_dict, filters = load(cfg, device)
    hookpoints = list(submodule_dict)
    return run_cache(cfg, lambda batch: model.capture(batch, hookpoints), submodule_dict, dataset, filters)


if __name__ == "__main__":
    main(parse_dataclass(CacheConfig))
