"""The SAE encoder's fp32 product on the tensor cores
(`csrc/sae_encode.cu`) and its plain PyTorch version.

relu((x - b_dec) @ W_enc + b_enc) in fp32, computed as six bf16 products
over a three-way split of both operands (a == a0 + a1 + a2 exactly, each
plane bf16), summed so that the tensor cores' truncating accumulation never
touches the running total.  That is fp32's precision, not TF32's: the
dropped terms are at most 2^-24 of each product (the source's head has the
argument).  Replaces no TPU kernel: the JAX package leaves this product to
XLA at Precision.HIGHEST (multimodal_sae_tpu/sae/model.py::pre_acts).

Bound on an H100: tensor-core operations, 6 * 2 * M * d_in * L FLOPs over
989 TFLOP/s (0.43 s at the text cache's 65,536 rows x 4,096 -> 131,072);
the fp32 output once at 3.35 TB/s.

`takes` is the rule `sae/model.py::pre_acts` follows: the kernel where the
tensors allow it and W_enc is not being trained, `torch.matmul` otherwise.
`encode` is one autograd Function whatever the grad mode: its forward is
the kernel (the plain version on the CPU), its backward the plain fp32
matmuls, so every encode of one SAE, with or without a graph, gives the
same bits.  The three planes of W_enc (1.5 times its bytes) are kept for
the weight split last on each device, re-split when its storage or
version counter moves (an in-place update) and freed when another weight
is split there or the weight dies; the planes of x - b_dec are made on
every call by the split pass.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional

import torch

from .. import kernels
from ..utils.profiling import count

launches = 0
"""Product launches so far (each follows one split of x); a run sets it to
0 and reads it after."""

K_STEP = 64
"""d_in must be a multiple of this: two of the kernel's K-slices of 32, and
every plane row on whole 128-byte lines."""
TILE_N = 128
"""The latent count must be a multiple of this (the kernel's tile width)."""

_planes: Dict[torch.device, tuple] = {}
"""device -> (weakref to W, key, planes) of the weight split last there:
at most one set of planes a device, 1.5 times one W_enc (3.2 GB at 131,072
latents), however many SAEs encode on it; an entry goes with its weight."""


def split_plain(a: torch.Tensor) -> torch.Tensor:
    """(3, *a.shape) bf16 planes with a0 + a1 + a2 == a exactly in fp32 for
    |a| >= 2^-110: a0 = bf16(a) (truncated instead where rounding would
    overflow), a1 = bf16(a - a0), a2 = a - a0 - a1."""
    a = a.float()
    h0 = a.to(torch.bfloat16)
    truncated = (a.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    h0 = torch.where(torch.isinf(h0) & torch.isfinite(a), truncated, h0)
    r1 = a - h0.float()
    h1 = r1.to(torch.bfloat16)
    h2 = (r1 - h1.float()).to(torch.bfloat16)
    return torch.stack([h0, h1, h2])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib():
    lib = kernels.load("sae_encode")
    for fn in (lib.split3_f32, lib.split3_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
    lib.sae_encode_f32.restype = ctypes.c_int
    lib.sae_encode_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def split(x: torch.Tensor, sub: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (3, *x.shape) bf16 planes of x - sub (sub: (x.shape[-1],) fp32,
    or None).  On a CUDA tensor (x fp32 or bf16, its last dimension a
    multiple of 8) this launches the split pass or raises; on a CPU tensor
    it runs `split_plain`."""
    if x.device.type == "cpu":
        return split_plain(x.float() if sub is None else x.float() - sub)
    if x.device.type != "cuda":
        raise ValueError(f"split runs on cuda or cpu, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the split pass takes float32 or bfloat16, got {x.dtype}")
    cols = x.shape[-1] if x.dim() else 1
    if cols % 8:
        raise ValueError(f"the split pass needs a last dimension that is a multiple of 8, got {cols}")
    if sub is not None and (sub.dtype != torch.float32 or sub.shape != (cols,) or sub.device != x.device):
        raise ValueError(f"sub must be float32 ({cols},) on {x.device}, got {sub.dtype} {tuple(sub.shape)}")
    x = _aligned(x)
    sub = None if sub is None else _aligned(sub)
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    if x.numel() == 0:
        return out
    lib = _lib()
    fn = lib.split3_f32 if x.dtype == torch.float32 else lib.split3_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), None if sub is None else sub.data_ptr(), out.data_ptr(), x.numel(), cols, stream)
    kernels.check(err, "split3")
    return out


def _weight_key(W: torch.Tensor) -> tuple:
    # An inference tensor keeps no version counter: it is split anew.
    version = None if W.is_inference() else W._version
    return (W.data_ptr(), version, tuple(W.shape), tuple(W.stride()), W.device)


def weight_planes(W: torch.Tensor) -> torch.Tensor:
    """The (3, d_in, L) bf16 planes of W, split once and kept until W's
    storage or version counter moves, another weight is split on its
    device (the old planes are freed before the new split) or W is freed."""
    key = _weight_key(W)
    held = _planes.pop(W.device, None)
    if held is not None and held[0]() is W and held[1] == key and key[1] is not None:
        _planes[W.device] = held
        return held[2]
    del held
    planes = split(W)
    _planes[W.device] = (weakref.ref(W, lambda ref, dev=W.device: _forget(dev, ref)), key, planes)
    return planes


def _forget(device: torch.device, ref: weakref.ref) -> None:
    if device in _planes and _planes[device][0] is ref:
        del _planes[device]


def encode_plain(x: torch.Tensor, W: torch.Tensor, b_enc: torch.Tensor, b_dec: torch.Tensor) -> torch.Tensor:
    """The same split product in plain PyTorch: the six products of the
    planes, each a full-K fp32 product of bf16 values, the five corrections
    summed apart and added to the main term, then b_enc and ReLU."""
    d_in = W.shape[0]
    a = split_plain(x.reshape(-1, d_in).float() - b_dec).float()
    w = split_plain(W).float()
    corr = a[0] @ w[1]
    for i, j in ((1, 0), (0, 2), (1, 1), (2, 0)):
        corr += a[i] @ w[j]
    out = a[0] @ w[0]
    out += corr
    return out.add_(b_enc).relu_().reshape(*x.shape[:-1], W.shape[1])


def _fits(x: torch.Tensor, W, b_enc: torch.Tensor, b_dec: torch.Tensor) -> bool:
    tensors = (x, W, b_enc, b_dec)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda and t.device == x.device for t in tensors):
        return False
    if W.dtype != torch.float32 or b_enc.dtype != torch.float32 or b_dec.dtype != torch.float32:
        return False
    if W.dim() != 2 or not x.is_floating_point() or x.dim() == 0:
        return False
    d_in, L = W.shape
    if d_in % K_STEP or L % TILE_N or x.shape[-1] != d_in or x.numel() == 0:
        return False
    return b_enc.shape == (L,) and b_dec.shape == (d_in,)


def takes(x: torch.Tensor, W, b_enc: torch.Tensor, b_dec: torch.Tensor) -> bool:
    """Whether `pre_acts` runs the kernel, from what the tensors show: all
    four on one CUDA device; W_enc a dense fp32 (d_in, L) matrix (not a
    quantised encoder) with d_in a multiple of 64 and L of 128; fp32
    biases of their shapes; x floating point, (..., d_in), with rows; and
    W_enc not being trained (`requires_grad` off).  Grad mode plays no
    part: a gradient to x or the biases runs through `encode`'s backward,
    so the clean and the ablated forwards of attribution take one
    algorithm.  The trainer's SAEs, whose W_enc requires grad, take
    `torch.matmul` on every call, under grad or not."""
    return _fits(x, W, b_enc, b_dec) and not W.requires_grad


def _product(x: torch.Tensor, W: torch.Tensor, b_enc: torch.Tensor, b_dec: torch.Tensor) -> torch.Tensor:
    """The forward: the split pass and the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    global launches
    if x.device.type == "cpu":
        return encode_plain(x, W, b_enc, b_dec)
    d_in, L = W.shape
    rows = x.reshape(-1, d_in)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        rows = rows.float()
    a = split(rows, b_dec)
    w = weight_planes(W)
    bias = _aligned(b_enc)
    out = torch.empty((rows.shape[0], L), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().sae_encode_f32(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                    rows.shape[0], d_in, L, stream)
    kernels.check(err, "sae_encode")
    launches += 1
    count("sae.encode_split_rows", rows.shape[0])
    return out.reshape(*x.shape[:-1], L)


class _Encode(torch.autograd.Function):
    """The split product forward, the plain fp32 matmuls backward: the
    gradients `torch.matmul`'s path gives, through the ReLU's mask of this
    forward's output."""

    @staticmethod
    def forward(ctx, x, W, b_enc, b_dec):
        out = _product(x, W, b_enc, b_dec)
        ctx.save_for_backward(x, W, b_dec, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, W, b_dec, out = ctx.saved_tensors
        d_in, L = W.shape
        g = torch.where(out > 0, grad, 0.0).reshape(-1, L)
        gx = gW = gb_enc = gb_dec = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[3]:
            ga = g @ W.t()
            if ctx.needs_input_grad[0]:
                gx = ga.to(x.dtype).reshape(x.shape)
            if ctx.needs_input_grad[3]:
                gb_dec = -ga.sum(0)
        if ctx.needs_input_grad[1]:
            gW = (x.reshape(-1, d_in).float() - b_dec).t() @ g
        if ctx.needs_input_grad[2]:
            gb_enc = g.sum(0)
        return gx, gW, gb_enc, gb_dec


def encode(x: torch.Tensor, W: torch.Tensor, b_enc: torch.Tensor, b_dec: torch.Tensor) -> torch.Tensor:
    """relu((x - b_dec) @ W + b_enc) in fp32, (..., d_in) -> (..., L).

    On CUDA tensors of the shapes and types `takes` admits this splits
    x - b_dec and launches the product, and raises on any other; on CPU
    tensors it runs `encode_plain`.  Differentiable in every input, by the
    plain matmuls (`_Encode`); the forward is the same with or without a
    graph."""
    if x.device.type != "cpu" and not _fits(x, W, b_enc, b_dec):
        raise ValueError(
            f"sae_encode takes x (..., d_in) and fp32 W (d_in, L), b_enc (L,), b_dec (d_in,) on one CUDA device, "
            f"d_in % {K_STEP} == 0, L % {TILE_N} == 0; got x {x.dtype} {tuple(x.shape)} on {x.device}, "
            f"W {W.dtype} {tuple(W.shape)} on {W.device}"
        )
    return _Encode.apply(x, W, b_enc, b_dec)
