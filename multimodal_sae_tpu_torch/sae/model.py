"""TopK sparse autoencoder (multimodal_sae_tpu/sae/model.py).

    params = {
        "W_enc": (d_in, L),   # stored transposed vs torch.nn.Linear
        "b_enc": (L,),
        "W_dec": (L, d_in),   # optional: the cache path never decodes
        "b_dec": (d_in,),
    }

    pre_acts = relu((x - b_dec) @ W_enc + b_enc)
    encode   = exact top-k of pre_acts
    decode   = sparse_decode(top_indices, top_acts) + b_dec
    forward  = fvu + AuxK dead-latent loss + Multi-TopK fvu (training)

plus the unit-norm decoder renorm and the projection of the decoder's
gradient off its rows, which the trainer applies around each step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch
from torch import nn

from ..config import SaeConfig
from ..device import DeviceLike, resolve_device, set_precision
from ..ops import sae_encode, top_k
from ..ops.sparse_decode import sparse_decode, topk_mask_decode
from ..ops.topk import kth_value
from ..models.quant import is_quantized, leaf_dtype, qmatmul, quantize_weight
from ..utils import natsorted

Params = Dict[str, torch.Tensor]
_Q8, _SCALE = "_q8", "_scale"  # buffer suffixes of a quantised parameter


class EncoderOutput(NamedTuple):
    top_acts: torch.Tensor
    """Activations of the top-k latents, (..., k)."""

    top_indices: torch.Tensor
    """Indices of the top-k features, (..., k), int32."""


class ForwardOutput(NamedTuple):
    sae_out: torch.Tensor

    latent_acts: Optional[torch.Tensor]
    """Activations of the top-k latents (None on the fast path unless
    `return_topk`; training uses `fired`)."""

    latent_indices: Optional[torch.Tensor]
    """Indices of the top-k features (see `latent_acts`)."""

    fvu: torch.Tensor
    """Fraction of variance unexplained."""

    auxk_loss: torch.Tensor
    """AuxK loss, if applicable."""

    multi_topk_fvu: torch.Tensor
    """Multi-TopK FVU, if applicable."""

    fired: Optional[torch.Tensor] = None
    """(L,) bool: latents selected with a positive pre-activation anywhere
    in the batch (fast path; the dead-feature bookkeeping reads it)."""


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
    """relu((x - b_dec) @ W_enc + b_enc) in the SAE's dtype.  Where
    `ops.sae_encode.takes` admits the tensors (fp32 on CUDA, a fitting
    shape, W_enc not being trained) it runs the split fp32 product on the
    tensor cores (`ops/sae_encode.py`: fp32's precision, not TF32's), with
    or without a graph, its gradient to x and the biases by the plain
    matmuls; otherwise the matmul is left to `torch.matmul`, as the JAX
    package leaves it to XLA, and fp32 runs with TF32 off
    (device.set_precision), matching the JAX side's HIGHEST.  The trainer's
    SAEs (W_enc requires grad) and every CPU call take `torch.matmul`.

    With a quantised encoder (`quantize_encoder`) the product is W8A8
    (models/quant.py): each row of x - b_dec quantised by its absmax, an
    int8 x int8 -> int32 product, scaled in fp32 (JAX sae/model.py:116-123).
    That moves top-k ties, so it never runs on the fp32 parity path; it is
    for inference only."""
    W = params["W_enc"]
    if is_quantized(W):
        sae_in = x.to(params["b_enc"].dtype) - params["b_dec"]
        return qmatmul(sae_in, W, int8=True).add_(params["b_enc"]).relu_()
    if sae_encode.takes(x, W, params["b_enc"], params["b_dec"]):
        return sae_encode.encode(x, W, params["b_enc"], params["b_dec"])
    out = (x.to(W.dtype) - params["b_dec"]) @ W
    return out.add_(params["b_enc"]).relu_()


def quantize_encoder(params: Params) -> Params:
    """The W8A8 encoder of the caching and interpretation paths (JAX
    sae/model.py:135-145): W_enc (d_in, L) replaced by its int8 form, one
    scale per latent, stored (L, d_in) as every quantised product is
    (models/quant.py); the decoder and biases are untouched.  Inference
    only: the training forward refuses it."""
    out = dict(params)
    out["W_enc"] = quantize_weight(params["W_enc"].t(), dim=1)
    return out


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


def _any_over_tokens(mask: torch.Tensor) -> torch.Tensor:
    return mask.reshape(-1, mask.shape[-1]).any(dim=0)


def forward(
    params: Params,
    x: torch.Tensor,
    cfg: SaeConfig,
    dead_mask: Optional[torch.Tensor] = None,
    *,
    fast: bool = True,
    return_topk: bool = False,
    mark: Optional[Callable[[str], None]] = None,
    total_variance: Optional[torch.Tensor] = None,
) -> ForwardOutput:
    """The training forward (multimodal_sae_tpu/sae/model.py `forward`;
    reference sae.py:193-247), differentiable in the parameters.

    `fast=True` decodes through `topk_mask_decode` (the dense threshold
    mask, every latent tied at the k-th value kept); `fast=False` through
    `select_topk` and `decode`, the sparse decode with its backward.  With
    `dead_mask` (L,) bool the AuxK loss is added: k_aux = d_in // 2 dead
    latents selected by their exact k_aux-th score (-inf for live latents,
    so with fewer dead latents the mask is the dead set), scaled by
    min(dead / k_aux, 1).  With `cfg.multi_topk` the 4k decode is added and,
    as in the reference, `sae_out` and `fired` become the 4k ones.
    `total_variance` is the denominator of the FVU, AuxK and Multi-TopK
    terms: by default sum((x - mean(x))^2) over `x`; a data-parallel
    trainer passes the global batch's (the JAX forward's `x` is the global
    array over its mesh), so that each rank's terms are its share of the
    global losses.  `mark(stage)`, when given, is called at the end of the "encode",
    "top_k", "masked_decode" and "losses" stages (chip_smoke.py times
    them)."""
    if is_quantized(params["W_enc"]):
        raise ValueError(
            "training forward requires a dense encoder — quantize_encoder is inference-only (its int8 VJP carries "
            "no weight gradients)"
        )
    dtype = params["W_enc"].dtype
    x = x.to(dtype)
    pre = pre_acts(params, x)
    if mark is not None:
        mark("encode")
    W_dec, b_dec = params["W_dec"], params["b_dec"]

    if fast:
        y, _dense, sel_mask = topk_mask_decode(pre, W_dec, cfg.k, mark=mark)
        sae_out = y + b_dec
        # Fired = selected and positive: a row with fewer than k positive
        # pre-activations has k-th value 0, and `pre >= 0` alone would mark
        # every latent of it as fired (the JAX package's rule, sae/model.py).
        fired = _any_over_tokens(sel_mask & (pre > 0))
        if return_topk:
            top_acts, top_indices = select_topk(pre.detach(), cfg.k)
        else:
            top_acts = top_indices = None
    else:
        top_acts, top_indices = select_topk(pre, cfg.k)
        if mark is not None:
            mark("top_k")
        sae_out = decode(params, top_acts, top_indices)
        if mark is not None:
            mark("masked_decode")
        fired = None

    e = sae_out - x
    if total_variance is None:
        total_variance = torch.sum((x - x.mean(dim=0)) ** 2)
    l2_loss = torch.sum(e * e)
    fvu = l2_loss / total_variance

    if dead_mask is not None:
        k_aux = x.shape[-1] // 2
        num_dead = dead_mask.sum().to(dtype)
        scale = torch.clamp(num_dead / k_aux, max=1.0)
        scores = torch.where(dead_mask, pre.detach(), float("-inf"))
        kth = kth_value(scores, min(k_aux, scores.shape[-1] - 1))
        del scores
        aux_mask = dead_mask & (pre >= kth)
        dense_aux = torch.where(aux_mask, pre, 0.0)
        e_hat = dense_aux @ W_dec.to(dtype) + b_dec
        auxk_loss = scale * torch.sum((e_hat - e) ** 2) / total_variance
    else:
        auxk_loss = torch.zeros((), dtype=dtype, device=x.device)

    if cfg.multi_topk:
        y4, _dense4, sel4 = topk_mask_decode(pre, W_dec, 4 * cfg.k)
        sae_out4 = y4 + b_dec
        multi_topk_fvu = torch.sum((sae_out4 - x) ** 2) / total_variance
        sae_out = sae_out4  # the reference's quirk (sae.py:232-238), kept
        if fired is not None:
            fired = _any_over_tokens(sel4 & (pre > 0))
        if top_acts is not None:
            top_acts, top_indices = select_topk(pre.detach(), 4 * cfg.k)
    else:
        multi_topk_fvu = torch.zeros((), dtype=dtype, device=x.device)
    if mark is not None:
        mark("losses")

    return ForwardOutput(sae_out, top_acts, top_indices, fvu, auxk_loss, multi_topk_fvu, fired)


@torch.no_grad()
def set_decoder_norm_to_unit_norm(params: Params) -> Params:
    """Renormalise the decoder's rows to unit norm (reference sae.py:249-255):
    W_dec / (||row|| + eps), in place (the trainer stores the result back;
    at 131,072 x 4,096 a copy would cost 2.1 GB).  Returns `params`."""
    W_dec = params["W_dec"]
    eps = torch.finfo(W_dec.dtype).eps
    W_dec.div_(torch.linalg.vector_norm(W_dec, dim=1, keepdim=True) + eps)
    return params


@torch.no_grad()
def remove_gradient_parallel_to_decoder_directions(params: Params, grads: Params) -> Params:
    """Project the decoder's gradient off the decoder's rows (reference
    sae.py:257-271), in place on grads["W_dec"]: g - (g . W_row) W_row.
    Returns `grads`."""
    W_dec, g = params["W_dec"], grads["W_dec"]
    parallel = torch.einsum("ld,ld->l", g, W_dec)
    g.sub_(parallel[:, None] * W_dec)
    return grads


class Sae(nn.Module):
    """(params, cfg, d_in) with the reference's object API: `pre_acts`,
    `select_topk`, `encode`, `decode`, `forward`, `save_to_disk`,
    `load_from_disk`, `load_from_hub`, `load_many`.  The parameters are
    buffers, which the cache and attribution paths never differentiate; the
    trainer turns on their `requires_grad` and keeps their gradients in
    `.grad`."""

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
            self._register(name, t)

    def _register(self, name: str, t) -> None:
        """A tensor as the buffer `name`; a quantised one as `name`_q8 and
        `name`_scale, which `params` joins again."""
        if is_quantized(t):
            self.register_buffer(name + _Q8, t["q8"])
            self.register_buffer(name + _SCALE, t["scale"])
        else:
            self.register_buffer(name, t)

    @property
    def params(self) -> Params:
        out = {}
        for name, t in self.named_buffers():
            if name.endswith(_Q8):
                base = name[: -len(_Q8)]
                out[base] = {"q8": t, "scale": getattr(self, base + _SCALE)}
            elif not name.endswith(_SCALE):
                out[name] = t
        return out

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype of the encoder: bf16 when it is quantised
        (JAX sae/model.py:330-333)."""
        return leaf_dtype(self.params["W_enc"])

    def quantize_encoder(self) -> "Sae":
        """Quantise W_enc in place (module-level `quantize_encoder`); returns
        self."""
        quantized = quantize_encoder(self.params)["W_enc"]
        del self._buffers["W_enc"]
        self._register("W_enc", quantized)
        return self

    def pre_acts(self, x: torch.Tensor) -> torch.Tensor:
        return pre_acts(self.params, x)

    def select_topk(self, latents: torch.Tensor) -> EncoderOutput:
        return select_topk(latents, self.cfg.k)

    def encode(self, x: torch.Tensor) -> EncoderOutput:
        return encode(self.params, x, self.cfg)

    def decode(self, top_acts: torch.Tensor, top_indices: torch.Tensor) -> torch.Tensor:
        return decode(self.params, top_acts, top_indices)

    def forward(self, x: torch.Tensor, dead_mask: Optional[torch.Tensor] = None, **kw) -> ForwardOutput:
        """The training forward (module-level `forward`), with TF32 off."""
        set_precision()
        return forward(self.params, x, self.cfg, dead_mask, **kw)

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
    def load_from_hub(
        name: str,
        hookpoint: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        *,
        decoder: bool = True,
        device: DeviceLike = None,
    ) -> "Sae":
        """The SAE of `hookpoint` in the local path or HuggingFace
        repository `name` (`serde.resolve_hub_path`: a path that exists
        is read as it is; reference sae.py:102-124)."""
        from .serde import resolve_hub_path

        return Sae.load_from_disk(resolve_hub_path(name, hookpoint), dtype, decoder=decoder, device=device)

    @staticmethod
    def load_many(
        name: str,
        local: bool = False,
        layers: Optional[list] = None,
        dtype: Optional[torch.dtype] = None,
        *,
        decoder: bool = True,
        pattern: Optional[str] = None,
        device: DeviceLike = None,
    ) -> Dict[str, "Sae"]:
        """One SAE per hookpoint directory of the local path or
        HuggingFace repository `name` (`local` skips the resolution),
        natsorted (reference sae.py:68-100): the directories `layers`
        names, else those whose names match `pattern` (fnmatch), else all.
        From the hub only `pattern + "/*"` is fetched, since each
        hookpoint's files sit one directory down."""
        from fnmatch import fnmatch

        from .serde import resolve_hub_path

        if local:
            repo_path = Path(name)
        else:
            allow = pattern + "/*" if pattern is not None else None
            repo_path = resolve_hub_path(name, None, allow_patterns=allow, require_cfg=False)
        if layers is not None:
            return {
                layer: Sae.load_from_disk(repo_path / layer, dtype, decoder=decoder, device=device)
                for layer in natsorted(layers)
            }
        dirs = [f for f in repo_path.iterdir() if f.is_dir() and (pattern is None or fnmatch(f.name, pattern))]
        return {
            f.name: Sae.load_from_disk(f, dtype, decoder=decoder, device=device)
            for f in natsorted(dirs, key=lambda f: f.name)
        }
