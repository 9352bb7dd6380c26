"""Image activation caching CLI:

    python -m multimodal_sae_tpu_torch.launch.cache.cache_image <llava checkpoint> \\
        <image dataset> --sae_path <dir or org/name> [--flash_attention] [--truncate_layers N] ...

The same flags as `python -m multimodal_sae_tpu.launch.cache.cache_image`
(reference launch/cache/cache_image.py:24-104).  Each image goes through
LLaVA-NeXT with the bare "<image>" prompt, and each row's leading BOS
position is dropped before encoding (reference cache.py:402-409).  The
subject (a local LLaVA-NeXT checkpoint directory) and the SAEs run on the
CUDA card; under `torchrun --nproc_per_node N` each rank drives one card
through `cache.run_cache`'s flow (contiguous shards, `Rank{r}_*` splits, a
barrier, the rank-0 merge, a barrier).  `--load_in_8bit`, `--int8_matmul`
and `--int8_vision` quantise the subject (models/quant.py), `--sae_int8`
the SAE encoders.  `--tp N` shards the language model over each group of
N consecutive ranks and replicates the tower; `--dp N` splits each step's
N x batch_size images over N copies of the subject, and each geometry
group of the tower over them (parallel/)."""

from __future__ import annotations

from ...config import CacheConfig
from ...device import DeviceLike, setup
from ...features import FeatureImageCache
from ...interp_utils import load_filter, load_saes
from ...parallel import initialize_distributed
from ...parallel.tensor_parallel import replicate_saes
from ...utils.cli import parse_dataclass
from ..utils import load_any_dataset, load_subject_model, validate_hookpoints
from .cache import run_cache


def main(cfg: CacheConfig, device: DeviceLike = None):
    device = setup(device)
    initialize_distributed(device)
    model, _processor, tokenizer = load_subject_model(
        cfg.model,
        flash_attention=cfg.flash_attention,
        hf_token=cfg.hf_token,
        truncate_layers=cfg.truncate_layers,
        device=device,
        load_in_8bit=cfg.load_in_8bit,
        int8_matmul=cfg.int8_matmul,
        int8_vision=cfg.int8_vision,
        tp=cfg.tp,
        dp=cfg.dp,
    )
    dataset = load_any_dataset(cfg.dataset, cfg.split)
    filters = load_filter(cfg.filters_path) if cfg.filters_path is not None else None
    submodule_dict = load_saes(cfg.sae_path, filters=filters, device=device, int8_encoder=cfg.sae_int8)
    replicate_saes(model, submodule_dict.values())
    hookpoints = list(submodule_dict.keys())
    validate_hookpoints(model, hookpoints)
    prompt = tokenizer("<image>", add_special_tokens=True)["input_ids"]

    def capture_fn(batch):
        images = [im.convert("RGB") for im in batch["image"]]
        prepared = model.prepare_inputs(images=images, prompt_ids=[prompt for _ in images])
        return model.capture(prepared, hookpoints)

    return run_cache(cfg, capture_fn, submodule_dict, dataset, filters, cache_cls=FeatureImageCache)


if __name__ == "__main__":
    main(parse_dataclass(CacheConfig))
