"""Adam's scaling, equal to `optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)`
as the JAX trainer uses it (multimodal_sae_tpu/train/trainer.py:176).

The update is optax's, operation by operation, so fp32 gives the same
roundings: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g² + b2 nu, the bias
corrections 1 - b^count in fp32, u = mu_hat / (sqrt(nu_hat) + eps), and an
int32 step count.  `torch.optim.Adam` is not used: its fused and foreach
forms round otherwise, and its state is not optax's.  The moments are
updated in place (at 131,072 x 4,096 each is 2.1 GB).

State: `AdamState(count, mu, nu)`, `mu` and `nu` dicts over the SAE's
parameter names.  `flatten_state` lists a state's tensors in the order
`jax.tree_util.tree_flatten` gives the optax state (fields in order, each
dict by sorted name), the order of the trainers' `leaf_{i}` files;
`unflatten_state` reads them back.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]

INT32_MAX = 2**31 - 1


class AdamState(NamedTuple):
    count: torch.Tensor  # int32, shape ()
    mu: Params
    nu: Params


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, held at the int32 maximum (optax's `safe_increment`)."""
    return torch.where(count < INT32_MAX, count + 1, count)


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in fp32, a device scalar."""
    base = torch.tensor(decay, dtype=torch.float32, device=count.device)
    return 1.0 - torch.pow(base, count.to(torch.float32))


class ScaleByAdam:
    """`init(params)` and `update(grads, state) -> (updates, state)`, as the
    optax transformation; the step is `params - lr * updates`."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={name: torch.zeros_like(p) for name, p in params.items()},
            nu={name: torch.zeros_like(p) for name, p in params.items()},
        )

    def update(self, grads: Params, state: AdamState) -> Tuple[Params, AdamState]:
        b1, b2 = self.b1, self.b2
        count = safe_increment(state.count)
        bc1, bc2 = bias_correction(b1, count), bias_correction(b2, count)
        updates = {}
        for name, g in grads.items():
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            denom = (nu / bc2.to(nu.dtype)).sqrt_().add_(self.eps)
            updates[name] = (mu / bc1.to(mu.dtype)).div_(denom)
        return updates, AdamState(count, state.mu, state.nu)


def flatten_state(state: NamedTuple) -> List[torch.Tensor]:
    """The state's tensors in `jax.tree_util.tree_flatten` order: each field
    in turn, a dict field by sorted key."""
    leaves: List[torch.Tensor] = []
    for value in state:
        if isinstance(value, dict):
            leaves.extend(value[name] for name in sorted(value))
        else:
            leaves.append(value)
    return leaves


def unflatten_state(leaves: List[torch.Tensor], like: NamedTuple) -> NamedTuple:
    """A state shaped like `like` from `leaves` in `flatten_state` order,
    each leaf cast to the dtype, device and shape of the one it replaces."""
    it = iter(leaves)

    def take(ref: torch.Tensor) -> torch.Tensor:
        return next(it).reshape(ref.shape).to(device=ref.device, dtype=ref.dtype, copy=True)

    fields = []
    for value in like:
        if isinstance(value, dict):
            fields.append({name: take(value[name]) for name in sorted(value)})
        else:
            fields.append(take(value))
    if next(it, None) is not None:
        raise ValueError(f"more leaves than the state holds ({len(flatten_state(like))})")
    return type(like)(*fields)
