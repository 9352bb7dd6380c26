"""Image activation caching CLI:

    python -m multimodal_sae_tpu_torch.launch.cache.cache_image <llava checkpoint> \\
        <image dataset> --sae_path <dir> [--flash_attention] [--truncate_layers N] ...

The same flags as `python -m multimodal_sae_tpu.launch.cache.cache_image`
(reference launch/cache/cache_image.py:24-104).  Each image goes through
LLaVA-NeXT with the bare "<image>" prompt, and each row's leading BOS
position is dropped before encoding (reference cache.py:402-409).  The
subject (a local LLaVA-NeXT checkpoint directory) and the SAEs run on the
CUDA card, in one process; int8, --tp and --dp are refused until their
slices are ported."""

from __future__ import annotations

from ...config import CacheConfig
from ...device import DeviceLike, setup
from ...features import FeatureImageCache
from ...interp_utils import load_filter, load_saes
from ...utils.cli import parse_dataclass
from ..utils import load_any_dataset, load_subject_model, refuse_unported, shard_info, validate_hookpoints


def main(cfg: CacheConfig, device: DeviceLike = None):
    device = setup(device)
    refuse_unported(cfg)
    rank, _world = shard_info()
    model, _processor, tokenizer = load_subject_model(
        cfg.model,
        flash_attention=cfg.flash_attention,
        hf_token=cfg.hf_token,
        truncate_layers=cfg.truncate_layers,
        device=device,
    )
    dataset = load_any_dataset(cfg.dataset, cfg.split)
    filters = load_filter(cfg.filters_path) if cfg.filters_path is not None else None
    submodule_dict = load_saes(cfg.sae_path, filters=filters, device=device)
    hookpoints = list(submodule_dict.keys())
    validate_hookpoints(model, hookpoints)
    prompt = tokenizer("<image>", add_special_tokens=True)["input_ids"]

    def capture_fn(batch):
        images = [im.convert("RGB") for im in batch["image"]]
        prepared = model.prepare_inputs(images=images, prompt_ids=[prompt for _ in images])
        return model.capture(prepared, hookpoints)

    cache = FeatureImageCache(capture_fn, submodule_dict, batch_size=cfg.batch_size, filters=filters)
    cache.enable_streaming(cfg.save_dir, cfg.n_splits, rank=rank)
    cache.run(cfg.ctx_len, dataset)
    cache.save_splits(n_splits=cfg.n_splits, save_dir=cfg.save_dir, rank=rank)
    cache.concate_safetensors(n_splits=cfg.n_splits, save_dir=cfg.save_dir)


if __name__ == "__main__":
    main(parse_dataclass(CacheConfig))
