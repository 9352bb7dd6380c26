"""Per-block max over the last axis: kernel K1 (`csrc/block_max.cu`) and its
plain PyTorch version.

Replaces multimodal_sae_tpu/ops/pallas_topk.py::pallas_block_max.  The JAX
dispatcher reaches that Pallas kernel only at block 128, which the cache
step never asks for (it filters at block 64, then 8), so there the reduce
runs as XLA's reshape-max.  The function is the same at every block: this
kernel takes each block the port's wide top-k uses.

Bound on an H100: memory.  The function reads N*W elements once and writes
N*W/block, so it cannot beat (N*W + N*W/block) * itemsize / 3.35 TB/s; at
the cache step's level 1, (16384, 131072) fp32 at block 64, that is
8.6 GB, about 2.6 ms.  The kernel's design (16-byte loads, a shuffle max
within the lanes of a block) is in the source."""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

launches = 0
"""Kernel launches so far; a run sets it to 0 and reads it after."""

BLOCKS = (8, 16, 32, 64, 128)


def block_max_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, W) -> (N, W // block): max of each contiguous `block`-wide slice."""
    n, w = x.shape
    return x.view(n, w // block, block).amax(-1)


def _fn(dtype: torch.dtype):
    lib = kernels.load("block_max")
    fn = lib.block_max_f32 if dtype == torch.float32 else lib.block_max_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def block_max(x: torch.Tensor, block: int) -> torch.Tensor:
    """Bit-exact per-block max; NaN propagates as in `torch.amax`.

    `x` is (N, W) with W a multiple of `block` (8, 16, 32, 64 or 128).  On a
    CUDA tensor (f32 or bf16, contiguous, 16-byte aligned) this launches K1
    or raises; on a CPU tensor it runs the plain version."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"block_max takes (N, W), got shape {tuple(x.shape)}")
    n, w = x.shape
    if block not in BLOCKS or w % block:
        raise ValueError(f"block must be one of {BLOCKS} and divide W={w}, got {block}")
    if x.device.type == "cpu":
        return block_max_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"block_max runs on cuda or cpu, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_max kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("block_max kernel needs a contiguous, 16-byte aligned input")
    out = torch.empty((n, w // block), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(x.dtype)(x.data_ptr(), out.data_ptr(), out.numel(), block, stream)
    kernels.check(err, "block_max")
    launches += 1
    return out
