"""Row gather of a matrix: kernel K2 (`csrc/gather_rows.cu`) in its three
modes, each beside its plain PyTorch version.

Replaces multimodal_sae_tpu/ops/pallas_gather.py::pallas_gather_rows, whose
contract is `gather_rows(W, idx) == W[idx]`.  On every path that reaches the
gather it is the SAE decode's (`y[n] = sum_j vals[n, j] * W[idx[n, j]]`,
multimodal_sae_tpu/ops/sparse_decode.py::gather_decode), so the kernel's
second mode, `gather_decode`, fuses the weighted sum and never writes the
gathered rows out.  The third mode, `splice_decode`, is the attribution
chunk's decode: F corrupted splices per token, read from the token's one
top-(k+1) pool, equal bit for bit to `gather_decode` of each re-selected
list plus the decoder bias, cast to the splice's dtype.  The TPU kernel's
limits (d a multiple of 2048, M a multiple of 8) come from its tiling and
are not kept: any number of rows, and d a multiple of the 16-byte vector.

Bound on an H100: bytes, the distinct rows of W named by idx read once plus
the indices, weights and output, over 3.35 TB/s (the splice: or its fp32
FMAs over 33.5 T FMA/s, whichever is larger)."""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

launches = 0
"""Kernel launches so far (copy and decode modes); a run sets it to 0 and
reads it after."""

splice_launches = 0
"""Launches of the splice mode so far, counted apart."""

DECODE_DTYPES = (torch.float32, torch.bfloat16)
PLAIN_ROWS = 128  # splice_decode_plain gathers (128, k, d) at a time: 512 MiB at k = 256, d = 4096 fp32


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


def drop_positions(wide_idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """(F, N) int32, `splice_decode`'s drop: feature feats[f]'s position in
    token n's pool (row n of wide_idx), k_wide where it is absent."""
    hit = wide_idx[None] == feats.to(wide_idx)[:, None, None]  # (F, N, k_wide)
    return torch.where(hit.any(-1), hit.int().argmax(-1), wide_idx.shape[1]).to(torch.int32)


def splice_lists(wide_idx: torch.Tensor, wide_vals: torch.Tensor, rows: torch.Tensor, drop: torch.Tensor, k: int):
    """(vals, idx), each (len(rows), k): token rows[i]'s pool without
    position drop[i], cut to k, the slot past the pool's end (only when the
    pool holds k entries and one was dropped) its last index with value 0."""
    kw = wide_idx.shape[1]
    j = torch.arange(k, device=wide_idx.device)
    order = j + (j >= drop[:, None]).to(j.dtype)  # skip the dropped entry
    past = order >= kw
    order = order.clamp_max(kw - 1)
    rows = rows[:, None]
    return wide_vals[rows, order].masked_fill(past, 0.0), wide_idx[rows, order]


def splice_decode_plain(wide_idx, wide_vals, drop, k: int, W, b_dec, clean) -> torch.Tensor:
    """Row f·N + n: clean[n] where drop[f, n] >= k (the list is the clean
    top-k); elsewhere `gather_decode_plain` of the re-selected list, + b_dec
    in W's dtype, cast to clean's dtype."""
    F, N = drop.shape
    out = clean.repeat(F, 1)
    hits = (drop < k).reshape(-1).nonzero().squeeze(1)
    for rows in hits.split(PLAIN_ROWS):  # (rows, k, d) gathered at a time
        vals, idx = splice_lists(wide_idx, wide_vals, rows % N, drop.reshape(-1)[rows], k)
        out[rows] = (gather_decode_plain(idx, vals, W) + b_dec).to(clean.dtype)
    return out


def splice_decode(
    wide_idx: torch.Tensor,
    wide_vals: torch.Tensor,
    drop: torch.Tensor,
    k: int,
    W: torch.Tensor,
    b_dec: torch.Tensor,
    clean: torch.Tensor,
) -> torch.Tensor:
    """The F corrupted splices of an attribution chunk, (F·N, d) in clean's
    dtype, row f·N + n for feature f at token n.

    `wide_idx`, `wide_vals` (N, k_wide): each token's top-k_wide pool in
    descending order, k <= k_wide <= k + 1, vals of W's dtype (fp32 or
    bf16); `drop` (F, N) integer: feature f's position in token n's pool,
    k_wide where it is absent; `b_dec` (d,) of W's dtype; `clean` (N, d),
    fp32 or bf16: the prefix's splice, `gather_decode` of each token's
    first k pool entries + b_dec, cast.  Feature f's list at token n is the
    pool without position drop[f, n], cut to k (a zero slot on the pool's
    last index closes it when k_wide == k and f was dropped), and the row
    equals `(gather_decode(list) + b_dec).to(clean.dtype)` bit for bit;
    where drop[f, n] >= k it is clean[n].  On CUDA tensors this launches
    K2's splice mode or raises; on CPU tensors it runs the plain version.
    A drop outside [0, k_wide] (never made by `drop_positions`) breaks the
    contract: it is refused on the CPU, and its row is undefined on the
    card, where checking would wait for the card."""
    global splice_launches
    if wide_idx.dim() != 2 or wide_vals.shape != wide_idx.shape:
        raise ValueError(f"pool idx {tuple(wide_idx.shape)} and vals {tuple(wide_vals.shape)} must be one (N, k_wide)")
    N, kw = wide_idx.shape
    if drop.dim() != 2 or drop.shape[1] != N:
        raise ValueError(f"drop must be (F, {N}), got {tuple(drop.shape)}")
    if not 1 <= k <= kw <= k + 1:
        raise ValueError(f"k={k} needs a pool of k or k + 1 entries, got {kw}")
    if W.dim() != 2 or b_dec.shape != (W.shape[1],) or clean.shape != (N, W.shape[1]):
        raise ValueError(f"W {tuple(W.shape)}, b_dec {tuple(b_dec.shape)} and clean {tuple(clean.shape)} "
                         f"must be (L, d), (d,) and ({N}, d)")
    if W.dtype not in DECODE_DTYPES or wide_vals.dtype != W.dtype or b_dec.dtype != W.dtype:
        raise TypeError(f"splice_decode takes fp32 or bf16 W with pool vals and b_dec of its dtype, got W "
                        f"{W.dtype}, vals {wide_vals.dtype}, b_dec {b_dec.dtype}")
    if clean.dtype not in DECODE_DTYPES or wide_idx.is_floating_point() or drop.is_floating_point():
        raise TypeError(f"splice_decode takes an fp32 or bf16 clean and integer idx and drop, got clean "
                        f"{clean.dtype}, idx {wide_idx.dtype}, drop {drop.dtype}")
    if all(t.device.type == "cpu" for t in (wide_idx, wide_vals, drop, W, b_dec, clean)):
        if drop.numel() and bool(((drop < 0) | (drop > kw)).any()):
            raise ValueError(f"drop positions must lie in [0, {kw}]")
        return splice_decode_plain(wide_idx, wide_vals, drop, k, W, b_dec, clean)
    _check_cuda("splice_decode", W, wide_idx, wide_vals, drop, b_dec, clean)
    F, d = drop.shape[0], W.shape[1]
    out = torch.empty(F * N, d, dtype=clean.dtype, device=W.device)
    if out.numel() == 0:
        return out
    idx32, drop32 = wide_idx.to(torch.int32).contiguous(), drop.to(torch.int32).contiguous()
    vals, bias, clean = wide_vals.contiguous(), b_dec.contiguous(), clean.contiguous()
    if any(t.data_ptr() % 16 for t in (W, bias, clean)):
        raise ValueError("splice_decode kernel needs W, b_dec and clean on 16-byte boundaries")
    with torch.cuda.device(W.device):
        err = _fn("splice_decode", [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])(
            W.data_ptr(), idx32.data_ptr(), vals.data_ptr(), drop32.data_ptr(), bias.data_ptr(),
            clean.data_ptr(), out.data_ptr(), W.shape[0], N, F, d, k, kw,
            int(W.dtype == torch.bfloat16), int(clean.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "splice_decode")
    splice_launches += 1
    return out
