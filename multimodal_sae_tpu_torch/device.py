"""Device selection and numeric settings shared by the port's entry points.

Entry points run on the card unless the caller names another device: with
`device=None` they resolve to `cuda` and raise when no CUDA device exists,
rather than carry on on the CPU.  Tests pass `device="cpu"` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda`; a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


def set_precision() -> None:
    """Keep fp32 matmuls and convolutions in full fp32 (no TF32).

    The JAX encoder runs at `Precision.HIGHEST` so the fp32 cache is exact
    (multimodal_sae_tpu/sae/model.py::pre_acts); TF32 would keep about three
    decimal digits and move top-k boundaries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup(device: DeviceLike = None) -> torch.device:
    """Resolve the device and apply the precision settings (cache entry
    points call this once)."""
    dev = resolve_device(device)
    set_precision()
    return dev
