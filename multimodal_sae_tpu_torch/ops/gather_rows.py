"""Row gather of a matrix: kernel K2 (`csrc/gather_rows.cu`) in its two
modes, each beside its plain PyTorch version.

Replaces multimodal_sae_tpu/ops/pallas_gather.py::pallas_gather_rows, whose
contract is `gather_rows(W, idx) == W[idx]`.  On every path that reaches the
gather it is the SAE decode's (`y[n] = sum_j vals[n, j] * W[idx[n, j]]`,
multimodal_sae_tpu/ops/sparse_decode.py::gather_decode), so the kernel's
second mode, `gather_decode`, fuses the weighted sum and never writes the
gathered rows out.  The TPU kernel's limits (d a multiple of 2048, M a
multiple of 8) come from its tiling and are not kept: any number of rows,
and d a multiple of the 16-byte vector.

Bound on an H100: bytes, the distinct rows of W named by idx read once plus
the indices, weights and output, over 3.35 TB/s."""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

launches = 0
"""Kernel launches so far (either mode); a run sets it to 0 and reads it
after."""

DECODE_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(W: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """W[idx] for a flat idx vector."""
    return W[idx.long()]


def gather_decode_plain(idx: torch.Tensor, vals: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """sum_j vals[..., j] * W[idx[..., j]] in fp32, output in vals' dtype
    (the JAX side's einsum with preferred_element_type = vals' dtype)."""
    rows = W[idx.long()]  # (..., k, d)
    y = torch.einsum("...k,...kd->...d", vals.float(), rows.float())
    return y.to(vals.dtype)


def _fn(name: str, argtypes):
    fn = getattr(kernels.load("gather_rows"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _check_cuda(what: str, W: torch.Tensor, *others: torch.Tensor) -> None:
    if W.device.type != "cuda" or any(t.device != W.device for t in others):
        raise ValueError(f"{what} needs its tensors on one CUDA device (or the CPU)")
    if W.dim() != 2 or not W.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous 2-D W, got {tuple(W.shape)}")
    if (W.shape[1] * W.element_size()) % 16:
        raise ValueError(
            f"{what} kernel needs rows of a multiple of 16 bytes, got d={W.shape[1]} "
            f"of {W.dtype}"
        )


def gather_rows(W: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """W[idx] for W (L, d) and a flat idx (M,): bit-exact.  On CUDA tensors
    this launches K2's copy mode or raises; on CPU tensors it runs the plain
    version.  The kernel writes zeros for an index outside [0, L)."""
    global launches
    if idx.dim() != 1:
        raise ValueError(f"idx must be flat, got {tuple(idx.shape)}")
    if W.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(W, idx)
    _check_cuda("gather_rows", W, idx)
    out = torch.empty(idx.shape[0], W.shape[1], dtype=W.dtype, device=W.device)
    if out.numel() == 0:
        return out
    idx32 = idx.to(torch.int32).contiguous()
    with torch.cuda.device(W.device):
        err = _fn("gather_rows", [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])(
            W.data_ptr(), idx32.data_ptr(), out.data_ptr(), W.shape[0], idx.shape[0],
            W.shape[1] * W.element_size(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "gather_rows")
    launches += 1
    return out


def gather_decode(idx: torch.Tensor, vals: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """y[..., :] = sum_j vals[..., j] * W[idx[..., j], :], accumulated in fp32
    in the order j = 0 .. k-1, output in vals' dtype.  On CUDA tensors (W
    fp32 or bf16, vals of W's dtype) this launches K2's decode mode or
    raises; on CPU tensors it runs the plain version.  The kernel is
    deterministic: equal inputs give equal bits."""
    global launches
    if idx.shape != vals.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and vals {tuple(vals.shape)} differ")
    if W.device.type == "cpu" and idx.device.type == "cpu" and vals.device.type == "cpu":
        return gather_decode_plain(idx, vals, W)
    _check_cuda("gather_decode", W, idx, vals)
    if W.dtype not in DECODE_DTYPES or vals.dtype != W.dtype:
        raise TypeError(f"gather_decode kernel takes fp32 or bf16 W and vals of its dtype, "
                        f"got W {W.dtype}, vals {vals.dtype}")
    lead, k = idx.shape[:-1], idx.shape[-1]
    d = W.shape[1]
    idx2 = idx.reshape(-1, k).to(torch.int32).contiguous()
    vals2 = vals.reshape(-1, k).contiguous()
    y = torch.empty(idx2.shape[0], d, dtype=W.dtype, device=W.device)
    if y.numel() == 0:
        return y.reshape(*lead, d)
    if k == 0:
        return y.zero_().reshape(*lead, d)
    with torch.cuda.device(W.device):
        err = _fn("gather_decode", [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])(
            W.data_ptr(), idx2.data_ptr(), vals2.data_ptr(), y.data_ptr(), W.shape[0],
            idx2.shape[0], d, k, int(W.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "gather_decode")
    launches += 1
    return y.reshape(*lead, d)
