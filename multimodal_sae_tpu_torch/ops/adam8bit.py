"""8-bit Adam: blockwise-quantized moments (multimodal_sae_tpu/ops/adam8bit.py
`scale_by_adam8bit`), in plain tensor ops.

Each leaf of at least `min_8bit_size` elements is flattened, zero-padded to
blocks of 2,048 and stored as int8 m with cube-root companding and uint8 v
with fourth-root companding, each block with its raw absmax as scale.
Smaller leaves keep fp32 moments in the same slots (scales of shape (0,)).
A step dequantizes, applies the bias-corrected Adam update, clips it to
Adam's own bound max(1, (1 - b1) / sqrt(1 - b2)) and requantizes.  The
state, `ScaleByAdam8bitState(count, m_q, m_scale, v_q, v_scale)`, flattens
in the JAX package's leaf order (ops/adam.py `flatten_state`); checkpoints
mark its encoding `adam8bit_format: 2`.

The JAX side's `jnp.cbrt` and `x ** 0.25` are taken here as `pow` with
exponents 1/3 and 0.25 in fp32; the two libraries' roundings differ in the
last bit of a few percent of elements, which moves a stored code by one
step for about one element in a million.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .adam import bias_correction, safe_increment

Params = Dict[str, torch.Tensor]

BLOCK = 2048
ADAM8BIT_FORMAT = 2


class ScaleByAdam8bitState(NamedTuple):
    count: torch.Tensor  # int32, shape ()
    m_q: Params  # int8 (nb, BLOCK) per leaf
    m_scale: Params  # fp32 (nb,) per leaf
    v_q: Params  # uint8 (nb, BLOCK) per leaf
    v_scale: Params  # fp32 (nb,) per leaf


def _blocked(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def _unblocked(x2: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return x2.reshape(-1)[:n].reshape(shape)


def _quant_signed(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (nb, B) -> (int8 round(127 cbrt(x / absmax)), absmax (nb,))."""
    absmax = x.abs().amax(dim=1)
    safe = torch.where(absmax == 0, 1.0, absmax)
    r = x / safe[:, None]
    cbrt = torch.sign(r) * r.abs().pow(1.0 / 3.0)
    return torch.round(127.0 * cbrt).clamp(-127, 127).to(torch.int8), absmax


def _deq_signed(q: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    r = q.float() / 127.0
    return (r * r * r) * absmax[:, None]


def _quant_unsigned(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (nb, B) >= 0 -> (uint8 round(255 (x / max)^(1/4)), max (nb,))."""
    amax = x.amax(dim=1)
    safe = torch.where(amax == 0, 1.0, amax)
    r = (x / safe[:, None]).pow(0.25)
    return torch.round(255.0 * r).clamp(0, 255).to(torch.uint8), amax


def _deq_unsigned(q: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    r = q.float() / 255.0
    return (r * r) * (r * r) * amax[:, None]


class ScaleByAdam8bit:
    """The 8-bit counterpart of `ops.adam.ScaleByAdam`: `init(params)` and
    `update(grads, state) -> (updates, state)`."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, min_8bit_size: int = 4096):
        self.b1, self.b2, self.eps, self.min_8bit_size = b1, b2, eps, min_8bit_size

    def init(self, params: Params) -> ScaleByAdam8bitState:
        m_q, m_scale, v_q, v_scale = {}, {}, {}, {}
        for name, p in params.items():
            empty = torch.zeros(0, dtype=torch.float32, device=p.device)
            if p.numel() < self.min_8bit_size:  # fp32 moments for small leaves
                m_q[name], v_q[name] = (torch.zeros(p.shape, dtype=torch.float32, device=p.device) for _ in "mv")
                m_scale[name], v_scale[name] = empty, empty.clone()
                continue
            nb = -(-p.numel() // BLOCK)
            m_q[name] = torch.zeros(nb, BLOCK, dtype=torch.int8, device=p.device)
            m_scale[name] = torch.zeros(nb, dtype=torch.float32, device=p.device)
            v_q[name] = torch.zeros(nb, BLOCK, dtype=torch.uint8, device=p.device)
            v_scale[name] = torch.zeros(nb, dtype=torch.float32, device=p.device)
        count = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
        return ScaleByAdam8bitState(count, m_q, m_scale, v_q, v_scale)

    def update(self, grads: Params, state: ScaleByAdam8bitState) -> Tuple[Params, ScaleByAdam8bitState]:
        b1, b2, eps = self.b1, self.b2, self.eps
        count = safe_increment(state.count)
        bc1, bc2 = bias_correction(b1, count), bias_correction(b2, count)
        # Exact Adam's step is bounded by this (Kingma & Ba §2.1); the
        # requantization noise can break the bound, so the 8-bit path clips.
        u_bound = max(1.0, (1.0 - b1) / (1.0 - b2) ** 0.5)
        updates = {}
        new = tuple({} for _ in range(4))
        for name, g in grads.items():
            mq, ms, vq, vs = (part[name] for part in state[1:])
            if g.numel() < self.min_8bit_size:  # fp32 path for small leaves
                g32 = g.float()
                m = b1 * mq + (1.0 - b1) * g32
                v = b2 * vq + (1.0 - b2) * g32 * g32
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                updates[name] = u.to(g.dtype)
                parts = (m, ms, v, vs)
            else:
                g2 = _blocked(g)
                m = b1 * _deq_signed(mq, ms) + (1.0 - b1) * g2
                v = b2 * _deq_unsigned(vq, vs) + (1.0 - b2) * g2 * g2
                u2 = ((m / bc1) / (torch.sqrt(v / bc2) + eps)).clamp(-u_bound, u_bound)
                updates[name] = _unblocked(u2, g.shape).to(g.dtype)
                parts = (*_quant_signed(m), *_quant_unsigned(v))
            for part, value in zip(new, parts):
                part[name] = value
        return updates, ScaleByAdam8bitState(count, *new)
