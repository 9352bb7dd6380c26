"""Causal flash attention, forward and backward: kernels K3
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`) and their plain
PyTorch versions.

Replaces the Pallas TPU kernel that multimodal_sae_tpu/models/llama.py::
flash_attention calls, forward and custom VJP.  Same signature and
(B, H, S, hd) layout; k and v may carry kvH <= H heads (grouped-query
attention), indexed as h // (H // kvH) without materialising the repeat.
The TPU wrapper's pad-to-128/512 bucketing is a TPU mechanism: the kernels
mask their own ragged edge.  `flash_attention` is differentiable: under
autograd it runs `FlashAttention`, whose forward keeps the rows' logsumexp
and whose backward is the K3 backward on CUDA and `flash_attention_bwd_plain`
on the CPU.

Bounds on an H100: tensor-core operations, 2 products of 2 * hd per causal
(query, valid key) pair forward and 5 backward, over 989 TFLOP/s: about
0.28 ms forward per layer at B=8, H=32, S=2048, hd=128, and 0.98 ms backward
at B=8, S=2432."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels

launches = 0
"""Forward kernel launches so far; a run sets it to 0 and reads it after."""

bwd_delta_launches = 0
"""Launches of the backward's D pass: rowsum(o * do), and q * scale in bf16."""

bwd_dkdv_launches = 0
"""Launches of the backward's dK/dV kernel."""

bwd_dq_launches = 0
"""Launches of the backward's dQ kernel."""

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


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, as the JAX wrapper folds it (llama.py:330)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _masked_logits(qs, k, pad_mask):
    """fp32 logits qs . k over (B, H, S, S) plus jax's finite additive mask,
    and the boolean mask (causal and valid key)."""
    H, kvH = qs.shape[1], k.shape[1]
    if kvH != H:
        k = k.repeat_interleave(H // kvH, dim=1)
    S = qs.shape[2]
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    mask = torch.ones(S, S, dtype=torch.bool, device=qs.device).tril()[None, None]
    if pad_mask is not None:
        mask = mask & pad_mask.bool()[:, None, None, :]
    return logits + torch.where(mask, 0.0, DEFAULT_MASK_VALUE), mask


def flash_attention_fwd_plain(q, k, v, pad_mask, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the plain forward (`flash_attention_plain`) and its fp32
    row logsumexp (B, H, S), +inf on rows with no valid key."""
    _check_shapes(q, k, v, pad_mask)
    H, kvH = q.shape[1], k.shape[1]
    logits, mask = _masked_logits(_scaled(q, scale), k, pad_mask)
    if kvH != H:
        v = v.repeat_interleave(H // kvH, dim=1)
    S = q.shape[2]
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = e.sum(-1, keepdim=True)
    out = torch.matmul(e / denom, v.float())
    lse = (m + torch.log(denom)).squeeze(-1)
    if pad_mask is not None:
        empty = ~mask.any(-1, keepdim=True)  # (B, 1, S, 1)
        fill = v.float().sum(2, keepdim=True) / (-(-S // PAD_BUCKET) * PAD_BUCKET)
        out = torch.where(empty, fill, out)
        lse = lse.masked_fill(empty.squeeze(-1), float("inf"))
    return out.to(q.dtype), lse


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
    return flash_attention_fwd_plain(q, k, v, pad_mask, scale)[0]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(name: str, library: str, argtypes):
    fn = getattr(kernels.load(library), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _check_kernel_inputs(what: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what} needs its tensors on one CUDA device (or the CPU)")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{what} kernel takes bfloat16, got {[t.dtype for t in tensors]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dim 64 or 128, got {q.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous inputs")


def _kv_valid(q, pad_mask):
    """The pad mask as the kernels' contiguous int32 key mask, or None."""
    if pad_mask is None:
        return None
    return pad_mask.to(device=q.device, dtype=torch.int32).contiguous()


def _scale_q(q, scale) -> float:
    """The scale rounded to q's dtype, as the JAX wrapper folds it
    (llama.py:330)."""
    return float(torch.tensor(scale, dtype=q.dtype))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, pad_mask, scale, need_lse: bool = False):
    """(out, lse): `flash_attention`'s forward without autograd, and the
    rows' fp32 logsumexp the backward needs.  On CUDA tensors this launches
    K3 (writing lse only with `need_lse`, else lse is None) or raises; on
    CPU tensors it runs `flash_attention_fwd_plain`."""
    global launches
    _check_shapes(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, pad_mask, scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention needs q, k, v on one CUDA device (or the CPU)")
    _check_kernel_inputs("flash_attention", q, k, v)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) if need_lse else None
    if out.numel() == 0:
        return out, lse
    kv_valid = _kv_valid(q, pad_mask)
    with torch.cuda.device(q.device):
        err = _fn("flash_attention_fwd_bf16", "flash_attention", [_P] * 6 + [_I] * 5 + [_F, _P])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid), out.data_ptr(), _ptr(lse),
            B, H, k.shape[1], S, hd, _scale_q(q, scale), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "flash_attention")
    launches += 1
    return out, lse


def fwd_resources(hd: int) -> dict:
    """Registers a thread (at launch, before the kernel's setmaxnreg moves
    them to its consumer warpgroups), dynamic shared memory a block and
    resident blocks an SM of the forward kernel at head dim `hd`, in its
    two-head form (the main path's), as the CUDA runtime reports them
    (needs the card)."""
    out = (ctypes.c_int * 3)()
    fn = _fn("flash_attention_fwd_resources", "flash_attention", [_I, _P])
    kernels.check(fn(hd, out), "flash_attention resources")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"), out))


def flash_attention_bwd_plain(q, k, v, pad_mask, o, lse, do, scale):
    """(dq, dk, dv): the math of jax's `mha_reference_bwd` in fp32, each
    gradient in its input's dtype.  P is rebuilt from the logits, jax's
    finite mask and the saved `lse`; dk and dv of a kv head sum over its
    H / kvH query heads (the transpose of the JAX side's repeat), and dq is
    taken with respect to the unscaled q through the multiply by the scale
    in q's dtype.  A row with no valid key (lse = +inf) gets P = 0: dq = 0
    there and nothing added to dk or dv.  jax's reference spreads such a
    row's `do` over all keys instead; the two agree when `do` is 0 on those
    rows, as it is on every caller's path (no real position reads them)."""
    _check_shapes(q, k, v, pad_mask)
    B, H, S, hd = q.shape
    kvH = k.shape[1]
    qs = _scaled(q, scale)
    logits, _ = _masked_logits(qs, k, pad_mask)
    p = torch.exp(logits - lse.float()[..., None])
    kf, vf = k.float(), v.float()
    if kvH != H:
        kf = kf.repeat_interleave(H // kvH, dim=1)
        vf = vf.repeat_interleave(H // kvH, dim=1)
    do32 = do.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, vf.transpose(-1, -2))
    delta = (o.float() * do32).sum(-1, keepdim=True)
    ds = (dp - delta) * p
    dq = _scaled(torch.matmul(ds, kf).to(q.dtype), scale)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    if kvH != H:
        dk = dk.view(B, kvH, H // kvH, S, hd).sum(2)
        dv = dv.view(B, kvH, H // kvH, S, hd).sum(2)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, pad_mask, o, lse, do, scale):
    """(dq, dk, dv) of `flash_attention`, from the forward's output `o`
    and row logsumexp `lse` (B, H, S) fp32.  On CUDA tensors (bf16, hd 64 or
    128, contiguous) this launches the K3 backward (the D pass, the dK/dV
    kernel, then the dQ kernel) or raises; on CPU tensors it runs
    `flash_attention_bwd_plain`, whose contract it keeps."""
    _check_shapes(q, k, v, pad_mask)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, pad_mask, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd needs CUDA tensors (or CPU ones)")
    _check_kernel_inputs("flash_attention_bwd", q, k, v, o, do)
    B, H, S, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must match q {tuple(q.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous (B, H, S) fp32 tensor, got {lse.dtype} {tuple(lse.shape)}")
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta, qs = bwd_delta(q, o, do, scale)
    dk, dv = bwd_dkdv(qs, k, v, pad_mask, lse, do, delta)
    return bwd_dq(qs, k, v, pad_mask, lse, do, delta, scale), dk, dv


def bwd_delta(q, o, do, scale):
    """(delta, qs): the D pass on checked CUDA tensors (`flash_attention_bwd`
    checks them), delta (B, H, S) fp32 = rowsum(o * do) and qs = q * scale
    in bf16, the scaled q both product kernels read."""
    global bwd_delta_launches
    B, H, S, hd = o.shape
    delta = torch.empty(B, H, S, dtype=torch.float32, device=o.device)
    qs = torch.empty_like(q)
    fn = _fn("flash_attention_bwd_delta_bf16", "flash_attention_bwd", [_P] * 5 + [_I] * 2 + [_F, _P])
    with torch.cuda.device(o.device):
        err = fn(q.data_ptr(), o.data_ptr(), do.data_ptr(), delta.data_ptr(), qs.data_ptr(), B * H * S, hd,
                 _scale_q(q, scale), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "flash_attention_bwd D pass")
    bwd_delta_launches += 1
    return delta, qs


def bwd_dkdv(qs, k, v, pad_mask, lse, do, delta):
    """(dk, dv): the dK/dV kernel on checked CUDA tensors, with `delta` and
    the scaled `qs` from `bwd_delta`."""
    global bwd_dkdv_launches
    B, H, S, hd = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kv_valid = _kv_valid(qs, pad_mask)
    with torch.cuda.device(qs.device):
        err = _fn("flash_attention_bwd_dkdv_bf16", "flash_attention_bwd", [_P] * 9 + [_I] * 5 + [_P])(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, k.shape[1], S, hd, torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "flash_attention_bwd dk/dv")
    bwd_dkdv_launches += 1
    return dk, dv


def bwd_dq(qs, k, v, pad_mask, lse, do, delta, scale):
    """dq: the dQ kernel on checked CUDA tensors, with `delta` and the
    scaled `qs` from `bwd_delta`."""
    global bwd_dq_launches
    B, H, S, hd = qs.shape
    dq = torch.empty_like(qs)
    kv_valid = _kv_valid(qs, pad_mask)
    with torch.cuda.device(qs.device):
        err = _fn("flash_attention_bwd_dq_bf16", "flash_attention_bwd", [_P] * 8 + [_I] * 5 + [_F, _P])(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, H, k.shape[1], S, hd, _scale_q(qs, scale), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "flash_attention_bwd dq")
    bwd_dq_launches += 1
    return dq


def bwd_resources(hd: int) -> dict:
    """Registers a thread, dynamic shared memory a block and resident blocks
    an SM of the backward's dK/dV and dQ kernels at head dim `hd`, as the
    CUDA runtime reports them (needs the card)."""
    out = (ctypes.c_int * 6)()
    fn = _fn("flash_attention_bwd_resources", "flash_attention_bwd", [_I, _P])
    kernels.check(fn(hd, out), "flash_attention_bwd resources")
    keys = ("registers", "smem_bytes", "blocks_per_sm")
    return {"dkdv": dict(zip(keys, out[:3])), "dq": dict(zip(keys, out[3:]))}


class FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd: the forward keeps q, k, v, its
    output and the rows' logsumexp; the backward is `flash_attention_bwd`
    (the K3 backward when the forward ran on CUDA, the plain pair on the
    CPU).  Gradients flow to q (unscaled), k and v; none to the mask."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, scale):
        out, lse = flash_attention_fwd(q, k, v, pad_mask, scale, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, pad_mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, pad_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, pad_mask, out, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


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
    JAX wrapper gives it (see `flash_attention_plain`).  When autograd
    tracks q, k or v, it runs through `FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, pad_mask, scale)
    return flash_attention_fwd(q, k, v, pad_mask, scale)[0]
