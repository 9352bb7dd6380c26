"""Carry weights between the JAX package's layouts and the port's.

The JAX package's arrays cross as numpy (`np.asarray` of a jax array; bf16
as an ml_dtypes array).  LLaMA: the JAX package stores projections as
(in, out) for `x @ W` and may stack its layers for `lax.scan`; the port keeps
PyTorch's (out, in) for `F.linear` and a list of per-layer dicts.  SAE: both
packages hold `W_enc (d_in, L)`, `b_enc`, `W_dec (L, d_in)`, `b_dec`, so only
the array type changes.  Optimizer state: the JAX trainer saves its optax
state as `leaf_{i}` arrays in `jax.tree_util.tree_flatten` order; the port's
states (ops/adam.py `AdamState`, ops/adam8bit.py `ScaleByAdam8bitState`)
flatten in the same order, so the arrays cross one for one.  CLIP and
LLaVA-NeXT: matrices are (in, out) there and (out, in) here, as for LLaMA.

Quantised leaves (models/quant.py) cross as {"q8", "scale"} dicts: a
matrix's `q8` is transposed like the matrix, so its scale runs over the
port's rows, and an embedding table's `q8` stays (V, d) with its (d,)
scale; the SAE's quantised W_enc crosses from (d_in, L) to (L, d_in).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.adam import flatten_state, unflatten_state

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


def _is_quantized(a) -> bool:
    return isinstance(a, Mapping) and "q8" in a


def _leaf_from_jax(a, transpose: bool, device: DeviceLike = None):
    """One JAX leaf, dense or quantised, -> the port's, transposed when it
    is a matrix the port keeps (out, in)."""
    if _is_quantized(a):
        q8 = np.asarray(a["q8"])
        return {"q8": tensor_from_numpy(q8.T if transpose else q8, device),
                "scale": tensor_from_numpy(a["scale"], device)}
    a = np.asarray(a)
    return tensor_from_numpy(a.T if transpose else a, device)


def _leaf_to_jax(t, transpose: bool):
    """One port leaf, dense or quantised, -> numpy in the JAX layout."""
    if _is_quantized(t):
        q8 = tensor_to_numpy(t["q8"])
        return {"q8": np.ascontiguousarray(q8.T) if transpose else q8, "scale": tensor_to_numpy(t["scale"])}
    a = tensor_to_numpy(t)
    return np.ascontiguousarray(a.T) if transpose else a


def sae_params_from_jax(params: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX SAE param dict -> the port's (same keys, same layouts; a
    quantised W_enc's q8 transposed to (L, d_in))."""
    return {name: _leaf_from_jax(params[name], _is_quantized(params[name]), device) for name in params}


def sae_params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's SAE param dict -> numpy arrays in the JAX package's layout."""
    return {name: _leaf_to_jax(t, _is_quantized(t)) for name, t in params.items()}


def llama_params_from_jax(params: Mapping, device: DeviceLike = None) -> dict:
    """A JAX LLaMA param tree (per-layer list, or stacked by
    `stack_layer_params`) -> the port's tree: `embed_tokens`, `norm`,
    `layers` as a list of dicts with (out, in) projections, and `lm_head`
    as (V, D) when the tree has one (an untied head)."""
    layers = params["layers"]
    if isinstance(layers, Mapping):  # stacked: one leading layer axis
        def layer_slice(a, i):
            return {k: np.asarray(v)[i] for k, v in a.items()} if _is_quantized(a) else np.asarray(a)[i]

        n = np.asarray(layers["input_layernorm"]).shape[0]
        layers = [{name: layer_slice(a, i) for name, a in layers.items()} for i in range(n)]

    out = {
        "embed_tokens": _leaf_from_jax(params["embed_tokens"], False, device),
        "norm": tensor_from_numpy(params["norm"], device),
        "layers": [{name: _leaf_from_jax(a, name in PROJECTIONS, device) for name, a in layer.items()}
                   for layer in layers],
    }
    if "lm_head" in params:
        out["lm_head"] = _leaf_from_jax(params["lm_head"], True, device)
    return out


def llama_params_to_jax(params: Mapping) -> dict:
    """The port's LLaMA tree -> numpy arrays in the JAX package's per-layer
    layout, (in, out) projections and `lm_head` (D, V) when there is one."""

    out = {
        "embed_tokens": _leaf_to_jax(params["embed_tokens"], False),
        "norm": tensor_to_numpy(params["norm"]),
        "layers": [{name: _leaf_to_jax(t, name in PROJECTIONS) for name, t in layer.items()}
                   for layer in params["layers"]],
    }
    if "lm_head" in params:
        out["lm_head"] = _leaf_to_jax(params["lm_head"], True)
    return out


CLIP_MATRICES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2", "patch_embedding")
"""CLIP matrices, (in, out) in the JAX package and (out, in) here; the
patch embedding is (3·p·p, D) there."""

PROJECTOR_MATRICES = ("linear_1", "linear_2")


def clip_params_from_jax(params: Mapping, device: DeviceLike = None) -> dict:
    """A JAX CLIP tower tree -> the port's, matrices transposed to (out, in)."""

    def convert(name, a):
        return _leaf_from_jax(a, name in CLIP_MATRICES, device)

    out = {name: convert(name, a) for name, a in params.items() if name != "layers"}
    out["layers"] = [{name: convert(name, a) for name, a in layer.items()} for layer in params["layers"]]
    return out


def clip_params_to_jax(params: Mapping) -> dict:
    """The port's CLIP tower tree -> numpy arrays in the JAX package's layout."""

    def convert(name, t):
        return _leaf_to_jax(t, name in CLIP_MATRICES)

    out = {name: convert(name, t) for name, t in params.items() if name != "layers"}
    out["layers"] = [{name: convert(name, t) for name, t in layer.items()} for layer in params["layers"]]
    return out


def llava_params_from_jax(params: Mapping, device: DeviceLike = None) -> dict:
    """A JAX LLaVA-NeXT tree (`LlavaNextModel.params`, its language model
    stacked or not) -> the port's: tower, projector, `image_newline` and
    language model."""
    return {
        "vision_tower": clip_params_from_jax(params["vision_tower"], device),
        "projector": {
            name: tensor_from_numpy(np.asarray(a).T if name in PROJECTOR_MATRICES else a, device)
            for name, a in params["projector"].items()
        },
        "image_newline": tensor_from_numpy(params["image_newline"], device),
        "language_model": llama_params_from_jax(params["language_model"], device),
    }


def llava_params_to_jax(params: Mapping) -> dict:
    """The port's LLaVA-NeXT tree -> numpy arrays in the JAX package's
    layout (the language model per layer, as `llava_params_from_state_dict`
    returns it)."""

    def projector(name, t):
        a = tensor_to_numpy(t)
        return np.ascontiguousarray(a.T) if name in PROJECTOR_MATRICES else a

    return {
        "vision_tower": clip_params_to_jax(params["vision_tower"]),
        "projector": {name: projector(name, t) for name, t in params["projector"].items()},
        "image_newline": tensor_to_numpy(params["image_newline"]),
        "language_model": llama_params_to_jax(params["language_model"]),
    }


def opt_state_from_jax(flat: Mapping[str, np.ndarray], like: NamedTuple) -> NamedTuple:
    """The JAX trainer's optimizer arrays `{"leaf_i": array}` (its
    `_flatten_opt_state`, or its `optimizer_*.safetensors`) -> a port state
    shaped like `like` (an `AdamState` or `ScaleByAdam8bitState` from the
    optimizer's `init`), on `like`'s device."""
    n = len(flatten_state(like))
    return unflatten_state([tensor_from_numpy(flat[f"leaf_{i}"], "cpu") for i in range(n)], like)


def opt_state_to_jax(state: NamedTuple) -> Dict[str, np.ndarray]:
    """A port optimizer state -> `{"leaf_i": numpy array}` in the JAX
    trainer's leaf order (its `_unflatten_opt_state` reads them)."""
    return {f"leaf_{i}": tensor_to_numpy(t) for i, t in enumerate(flatten_state(state))}
