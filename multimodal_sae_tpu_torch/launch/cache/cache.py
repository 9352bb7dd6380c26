"""Text activation caching CLI:

    python -m multimodal_sae_tpu_torch.launch.cache.cache <model> <dataset> \\
        --sae_path <dir> [--flash_attention] [--truncate_layers N] ...

The same flags as `python -m multimodal_sae_tpu.launch.cache.cache`.  The
subject (`synthetic://dM,L,V` or a local plain-LLaMA checkpoint directory)
and the SAEs run on the CUDA card, in one process; int8, --tp, --dp and
LLaVA checkpoints are refused until their slices are ported."""

from __future__ import annotations

from ...config import CacheConfig
from ...device import DeviceLike, setup
from ...features import FeatureCache
from ...interp_utils import load_filter, load_saes
from ...train.data import chunk_and_tokenize
from ...utils.cli import parse_dataclass
from ..utils import load_any_dataset, load_subject_or_synthetic, shard_info, validate_hookpoints


def main(cfg: CacheConfig, device: DeviceLike = None):
    device = setup(device)
    rank, _world = shard_info()
    model, _, tokenizer = load_subject_or_synthetic(cfg, device=device)

    dataset = load_any_dataset(cfg.dataset, cfg.split)
    if "input_ids" not in dataset.column_names:
        if tokenizer is None:
            raise ValueError("a synthetic subject needs a tokenized dataset")
        dataset = chunk_and_tokenize(dataset, tokenizer, max_seq_len=cfg.ctx_len)

    filters = load_filter(cfg.filters_path) if cfg.filters_path is not None else None
    submodule_dict = load_saes(cfg.sae_path, filters=filters, device=device)
    hookpoints = list(submodule_dict.keys())
    validate_hookpoints(model, hookpoints)

    cache = FeatureCache(
        lambda batch: model.capture(batch, hookpoints),
        submodule_dict,
        batch_size=cfg.batch_size,
        filters=filters,
    )
    cache.enable_streaming(cfg.save_dir, cfg.n_splits, rank=rank)
    cache.run(cfg.ctx_len, dataset)
    cache.save_splits(n_splits=cfg.n_splits, save_dir=cfg.save_dir, rank=rank)
    cache.concate_safetensors(n_splits=cfg.n_splits, save_dir=cfg.save_dir)


if __name__ == "__main__":
    main(parse_dataclass(CacheConfig))
