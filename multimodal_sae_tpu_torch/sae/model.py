"""TopK sparse autoencoder, inference half (multimodal_sae_tpu/sae/model.py).

    params = {
        "W_enc": (d_in, L),   # stored transposed vs torch.nn.Linear
        "b_enc": (L,),
        "W_dec": (L, d_in),   # optional: the cache path never decodes
        "b_dec": (d_in,),
    }

    pre_acts = relu((x - b_dec) @ W_enc + b_enc)
    encode   = exact top-k of pre_acts
    decode   = sparse_decode(top_indices, top_acts) + b_dec   (forward only)

The training forward, AuxK, the decoder renorm and decode's backward come
with the training slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Optional, Union

import torch
from torch import nn

from ..config import SaeConfig
from ..device import DeviceLike, resolve_device
from ..ops import top_k
from ..ops.sparse_decode import sparse_decode
from ..utils import natsorted

Params = Dict[str, torch.Tensor]


class EncoderOutput(NamedTuple):
    top_acts: torch.Tensor
    """Activations of the top-k latents, (..., k)."""

    top_indices: torch.Tensor
    """Indices of the top-k features, (..., k), int32."""


def init_params(
    d_in: int,
    cfg: SaeConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    decoder: bool = True,
) -> Params:
    """Initialize like the reference (sae.py:54-66): encoder weight
    ~ U(-1/sqrt(d_in), 1/sqrt(d_in)), zero biases, decoder = the encoder's
    transpose with unit-norm rows when `cfg.normalize_decoder`.  Drawn on
    `device` from `generator` (a torch.Generator on that device)."""
    num_latents = cfg.num_latents_for(d_in)
    bound = 1.0 / d_in**0.5
    W_enc = torch.empty(d_in, num_latents, dtype=torch.float32, device=device)
    W_enc.uniform_(-bound, bound, generator=generator)
    params: Params = {
        "W_enc": W_enc.to(dtype),
        "b_enc": torch.zeros(num_latents, dtype=dtype, device=device),
        "b_dec": torch.zeros(d_in, dtype=dtype, device=device),
    }
    if decoder:
        W_dec = W_enc.T.contiguous().to(dtype)
        if cfg.normalize_decoder:
            eps = torch.finfo(W_dec.dtype).eps
            W_dec = W_dec / (torch.linalg.vector_norm(W_dec, dim=1, keepdim=True) + eps)
        params["W_dec"] = W_dec
    return params


def pre_acts(params: Params, x: torch.Tensor) -> torch.Tensor:
    """relu((x - b_dec) @ W_enc + b_enc) in the SAE's dtype.  The matmul is
    left to `torch.matmul`, as the JAX package leaves it to XLA; fp32 runs
    with TF32 off (device.set_precision), matching the JAX side's HIGHEST."""
    W = params["W_enc"]
    out = (x.to(W.dtype) - params["b_dec"]) @ W
    return out.add_(params["b_enc"]).relu_()


def select_topk(latents: torch.Tensor, k: int) -> EncoderOutput:
    """Exact top-k of the (post-ReLU, hence finite) latents."""
    return EncoderOutput(*top_k(latents, k, assume_finite=True))


def encode(params: Params, x: torch.Tensor, cfg: SaeConfig) -> EncoderOutput:
    return select_topk(pre_acts(params, x), cfg.k)


def decode(params: Params, top_acts: torch.Tensor, top_indices: torch.Tensor) -> torch.Tensor:
    """Sparse decode + decoder bias: kernel K2's decode mode on CUDA."""
    if "W_dec" not in params:
        raise KeyError("the SAE was loaded without its decoder (decoder=False)")
    W_dec = params["W_dec"]
    return sparse_decode(top_indices, top_acts.to(W_dec.dtype), W_dec) + params["b_dec"]


class Sae(nn.Module):
    """(params, cfg, d_in) with the reference's object API: `pre_acts`,
    `select_topk`, `encode`, `decode`, `save_to_disk`, `load_from_disk`,
    `load_many`.  The parameters are buffers (nothing here has a
    backward)."""

    def __init__(
        self,
        d_in: int,
        cfg: SaeConfig,
        dtype: torch.dtype = torch.float32,
        *,
        decoder: bool = True,
        params: Optional[Params] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.d_in = d_in
        self.num_latents = cfg.num_latents_for(d_in)
        if params is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(d_in, cfg, gen, dev, dtype=dtype, decoder=decoder)
        for name, t in params.items():
            self.register_buffer(name, t)

    @property
    def params(self) -> Params:
        return dict(self.named_buffers())

    def pre_acts(self, x: torch.Tensor) -> torch.Tensor:
        return pre_acts(self.params, x)

    def select_topk(self, latents: torch.Tensor) -> EncoderOutput:
        return select_topk(latents, self.cfg.k)

    def encode(self, x: torch.Tensor) -> EncoderOutput:
        return encode(self.params, x, self.cfg)

    def decode(self, top_acts: torch.Tensor, top_indices: torch.Tensor) -> torch.Tensor:
        return decode(self.params, top_acts, top_indices)

    def save_to_disk(self, path: Union[Path, str]) -> None:
        from .serde import save_sae_to_disk

        save_sae_to_disk(self.params, self.cfg, self.d_in, path)

    @staticmethod
    def load_from_disk(
        path: Union[Path, str],
        dtype: Optional[torch.dtype] = None,
        *,
        decoder: bool = True,
        device: DeviceLike = None,
    ) -> "Sae":
        from .serde import load_sae_from_disk

        params, cfg, d_in = load_sae_from_disk(
            path, resolve_device(device), dtype=dtype, decoder=decoder
        )
        return Sae(d_in, cfg, params=params, decoder=decoder)

    @staticmethod
    def load_many(
        name: str,
        dtype: Optional[torch.dtype] = None,
        *,
        decoder: bool = True,
        device: DeviceLike = None,
    ) -> Dict[str, "Sae"]:
        """One SAE per hookpoint directory under the local path `name`,
        natsorted (reference sae.py:68-100).  Hub downloads need a network
        and wait for a later slice."""
        root = Path(name)
        if not root.is_dir():
            raise FileNotFoundError(f"{name} is not a local SAE directory")
        dirs = [f for f in root.iterdir() if f.is_dir()]
        return {
            f.name: Sae.load_from_disk(f, dtype, decoder=decoder, device=device)
            for f in natsorted(dirs, key=lambda f: f.name)
        }
