"""Causal flash-attention forward: kernel K3 (`csrc/flash_attention.cu`) and
its plain PyTorch version.

Replaces the forward of the Pallas TPU kernel that
multimodal_sae_tpu/models/llama.py::flash_attention calls.  Same signature
and (B, H, S, hd) layout; k and v may carry kvH <= H heads (grouped-query
attention), indexed as h // (H // kvH) without materialising the repeat.
The TPU wrapper's pad-to-128/512 bucketing is a TPU mechanism: the kernel
masks its own ragged edge.

Bound on an H100: tensor-core operations, 2*B*H*S^2*hd causal FLOPs over
989 TFLOP/s, about 0.28 ms per layer at B=8, H=32, S=2048, hd=128."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import kernels

launches = 0
"""Kernel launches so far; a run sets it to 0 and reads it after."""

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
"""The additive mask of jax's `mha_reference` (its DEFAULT_MASK_VALUE)."""

HEAD_DIMS = (64, 128)

PAD_BUCKET = 128
"""The JAX wrapper pads S to a multiple of this when it gets a pad mask
(llama.py:313); it shows only in the rows that have no valid key."""


def _check_shapes(q, k, v, pad_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, hd)")
    B, H, S, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, hd):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"H={H} must be a multiple of kvH={k.shape[1]}")
    if pad_mask is not None and tuple(pad_mask.shape) != (B, S):
        raise ValueError(f"pad_mask must be (B, S)={(B, S)}, got {tuple(pad_mask.shape)}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """The math of jax's `mha_reference` (causal, kv pad mask, additive mask
    value), in fp32, output in q's dtype.  The scale is folded into q in q's
    dtype first, as the JAX wrapper does.

    A query with no valid key (a leading pad query under left padding) gets
    what the JAX wrapper gives it: the finite mask makes its weights equal
    over the keys of the sequence the wrapper padded to a multiple of 128
    (the pad keys' v being zero), so its output is sum(v) / S rounded up to
    128.  No real position reads such a row."""
    _check_shapes(q, k, v, pad_mask)
    H, kvH = q.shape[1], k.shape[1]
    q = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if kvH != H:
        k = k.repeat_interleave(H // kvH, dim=1)
        v = v.repeat_interleave(H // kvH, dim=1)
    S = q.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[None, None]
    if pad_mask is not None:
        mask = mask & pad_mask.bool()[:, None, None, :]
    logits = logits + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    weights = e / e.sum(-1, keepdim=True)
    out = torch.matmul(weights, v.float())
    if pad_mask is not None:
        empty = ~mask.any(-1, keepdim=True)  # (B, 1, S, 1)
        fill = v.float().sum(2, keepdim=True) / (-(-S // PAD_BUCKET) * PAD_BUCKET)
        out = torch.where(empty, fill, out)
    return out.to(q.dtype)


def _fn():
    fn = kernels.load("flash_attention").flash_attention_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Causal attention over (B, H, S, hd); `pad_mask` (B, S) marks real
    tokens (keys where it is 0 are excluded).

    On CUDA tensors (bf16, hd 64 or 128, contiguous) this launches K3 or
    raises; on CPU tensors it runs the plain version.  A query with no valid
    key (a leading pad query under left padding) gets, in both, what the
    JAX wrapper gives it (see `flash_attention_plain`)."""
    global launches
    _check_shapes(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pad_mask, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention needs q, k, v on one CUDA device (or the CPU)")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bfloat16, got {q.dtype}")
    B, H, S, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim 64 or 128, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kv_valid = None
    if pad_mask is not None:
        kv_valid = pad_mask.to(device=q.device, dtype=torch.int32).contiguous()
    # Rounded to q's dtype, as the JAX wrapper folds it (llama.py:330).
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(),
            B, H, k.shape[1], S, hd, scale_q, stream,
        )
    kernels.check(err, "flash_attention")
    launches += 1
    return out
