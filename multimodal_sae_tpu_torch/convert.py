"""Carry weights between the JAX package's layouts and the port's.

The JAX package's arrays cross as numpy (`np.asarray` of a jax array; bf16
as an ml_dtypes array).  LLaMA: the JAX package stores projections as
(in, out) for `x @ W` and may stack its layers for `lax.scan`; the port keeps
PyTorch's (out, in) for `F.linear` and a list of per-layer dicts.  SAE: both
packages hold `W_enc (d_in, L)`, `b_enc`, `W_dec (L, d_in)`, `b_dec`, so only
the array type changes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device

PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
"""Per-layer matrices stored (in, out) by the JAX package, (out, in) here;
the untied `lm_head` ((D, V) there, (V, D) here) crosses the same way."""


def tensor_from_numpy(a, device: DeviceLike = None) -> torch.Tensor:
    """numpy (bf16 included, as ml_dtypes) -> torch on `device`."""
    a = np.array(a, order="C")  # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host (bf16 as an ml_dtypes array)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def sae_params_from_jax(params: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX SAE param dict -> the port's (same keys, same layouts)."""
    return {name: tensor_from_numpy(params[name], device) for name in params}


def sae_params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's SAE param dict -> numpy arrays in the JAX package's layout."""
    return {name: tensor_to_numpy(t) for name, t in params.items()}


def llama_params_from_jax(params: Mapping, device: DeviceLike = None) -> dict:
    """A JAX LLaMA param tree (per-layer list, or stacked by
    `stack_layer_params`) -> the port's tree: `embed_tokens`, `norm`,
    `layers` as a list of dicts with (out, in) projections, and `lm_head`
    as (V, D) when the tree has one (an untied head)."""
    layers = params["layers"]
    if isinstance(layers, Mapping):  # stacked: one leading layer axis
        arrays = {name: np.asarray(a) for name, a in layers.items()}
        n = next(iter(arrays.values())).shape[0]
        layers = [{name: a[i] for name, a in arrays.items()} for i in range(n)]

    def convert(name, a):
        a = np.asarray(a)
        return tensor_from_numpy(a.T if name in PROJECTIONS else a, device)

    out = {
        "embed_tokens": tensor_from_numpy(params["embed_tokens"], device),
        "norm": tensor_from_numpy(params["norm"], device),
        "layers": [{name: convert(name, a) for name, a in layer.items()} for layer in layers],
    }
    if "lm_head" in params:
        out["lm_head"] = tensor_from_numpy(np.asarray(params["lm_head"]).T, device)
    return out


def llama_params_to_jax(params: Mapping) -> dict:
    """The port's LLaMA tree -> numpy arrays in the JAX package's per-layer
    layout, (in, out) projections and `lm_head` (D, V) when there is one."""

    def convert(name, t):
        a = tensor_to_numpy(t)
        return np.ascontiguousarray(a.T) if name in PROJECTIONS else a

    out = {
        "embed_tokens": tensor_to_numpy(params["embed_tokens"]),
        "norm": tensor_to_numpy(params["norm"]),
        "layers": [{name: convert(name, t) for name, t in layer.items()} for layer in params["layers"]],
    }
    if "lm_head" in params:
        out["lm_head"] = np.ascontiguousarray(tensor_to_numpy(params["lm_head"]).T)
    return out
