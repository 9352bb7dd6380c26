"""SAE checkpoint (de)serialization, byte-equal to
multimodal_sae_tpu/sae/serde.py::save_sae_to_disk.

    {path}/sae.safetensors   encoder.weight (L, d_in), encoder.bias (L,),
                             W_dec (L, d_in), b_dec (d_in,)
    {path}/cfg.json          SaeConfig fields + {"d_in": ...}

A repository name that is not a local path resolves through
`huggingface_hub.snapshot_download` (`resolve_hub_path`), which serves the
local HuggingFace cache with no network under `HF_HUB_OFFLINE=1`.

The encoder weight is held as (d_in, L) for `x @ W_enc`; the transpose
happens here at the file boundary, as in the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch

from ..config import SaeConfig
from ..utils.safetensors_io import load_file, save_file

Params = Dict[str, torch.Tensor]


def save_sae_to_disk(
    params: Params, cfg: SaeConfig, d_in: int, path: Union[Path, str]
) -> None:
    """Write sae.safetensors + cfg.json."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors = {
        "encoder.weight": params["W_enc"].T,
        "encoder.bias": params["b_enc"],
        "b_dec": params["b_dec"],
    }
    if "W_dec" in params:
        tensors["W_dec"] = params["W_dec"]
    save_file(tensors, path / "sae.safetensors")
    with open(path / "cfg.json", "w") as f:
        json.dump({**cfg.to_dict(), "d_in": d_in}, f)


def load_sae_from_disk(
    path: Union[Path, str],
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
    *,
    decoder: bool = True,
) -> Tuple[Params, SaeConfig, int]:
    """Read the directory layout above onto `device`.  `decoder=False`
    skips W_dec (the reference's `strict=decoder` partial load)."""
    path = Path(path)
    with open(path / "cfg.json") as f:
        cfg_dict = json.load(f)
    d_in = cfg_dict.pop("d_in")
    cfg = SaeConfig.from_dict(cfg_dict)
    tensors = load_file(path / "sae.safetensors")

    def place(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype or t.dtype).contiguous()

    params: Params = {
        "W_enc": place(tensors["encoder.weight"].T),
        "b_enc": place(tensors["encoder.bias"]),
        "b_dec": place(tensors["b_dec"]),
    }
    if decoder:
        if "W_dec" not in tensors:
            raise KeyError(f"W_dec missing from {path}/sae.safetensors but decoder=True")
        params["W_dec"] = place(tensors["W_dec"])
    return params, cfg, d_in


def resolve_hub_path(
    name: str,
    hookpoint: Optional[str],
    allow_patterns: Optional[str] = None,
    *,
    require_cfg: bool = True,
) -> Path:
    """A local path, or the local directory of the HuggingFace repository
    `name` (multimodal_sae_tpu/sae/serde.py `resolve_hub_path`, reference
    sae.py:102-124).  A path that exists passes through, joined with
    `hookpoint` when one is given.  Otherwise `snapshot_download` fetches
    the repository, or only `f"{hookpoint}/*"` of it, or returns its
    snapshot in the cache (offline: a repository missing from the cache
    raises huggingface_hub's `LocalEntryNotFoundError`).

    `require_cfg` applies only when `hookpoint is None`: a single-SAE
    repository holds cfg.json at its root, while `load_many`'s
    multi-hookpoint repositories hold it one directory down and pass False."""
    p = Path(name)
    if p.exists():
        return p / hookpoint if hookpoint else p
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(f"{name} is not a local path and huggingface_hub is unavailable") from e
    pattern = allow_patterns or (f"{hookpoint}/*" if hookpoint is not None else None)
    repo_path = Path(snapshot_download(name, allow_patterns=pattern))
    if hookpoint is not None:
        repo_path = repo_path / hookpoint
    elif require_cfg and not (repo_path / "cfg.json").exists():
        raise FileNotFoundError("No config file found; try specifying a layer.")
    return repo_path
