#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`multimodal_sae_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and ends the run with a non-zero exit code:

1. build: print the card's name and power limit, build the CUDA kernels of
   `multimodal_sae_tpu_torch/csrc/` with nvcc for sm_90a (one process per
   source, in parallel);
2. block_max (K1) against its plain version, bit-exact, at the shapes of the
   main path's two filter levels and at bf16 block 128, then at every block
   it takes;
3. flash_attention (K3) against its plain version at LLaMA-3-8B's attention
   shape, unmasked and with one row left-padded by 100, each timed as the
   median, min and max of 5 repeats beside its bound, its TFLOP/s and SDPA
   (with the pad mask where there is one), with the forward kernel's
   registers, shared memory and blocks per SM at hd 128 and 64; then at edge
   shapes;
4. flash_attention_bwd (K3 backward): the kernels' forward and backward
   against the plain pair at (2, 32, 8, 2,432, 128) bf16, unmasked and with
   row 0 left-padded by 300 (dO zero on its rows without a valid key): the
   forward's output and logsumexp, then dq, dk and dv, each side from its
   own forward, and a second backward equal bit for bit; then an edge set
   (S = 1, 17, 65, 130, 300; kvH = H and 1; hd 64; left pads past one
   64-row tile) held the same way; then timed at B = 8 (the D pass, dK/dV
   and dQ apart, with each product kernel's registers, shared memory and
   blocks per SM) beside its bound and SDPA's GQA backward, and the
   forward with lse (5 repeats, its TFLOP/s) beside its bound and SDPA's
   GQA forward;
5. cache_path: a random LLaMA-3-8B-width subject (25 layers for hookpoint
   layers.24, bf16, flash attention) feeding a 131,072-latent k=256 fp32 SAE
   (saved with `save_to_disk`, read back through `load_saes`) through
   `FeatureCache` with streaming splits over 4 batches of 8 x 2,048 tokens,
   then `save_splits` and `concate_safetensors`; checks the launch counts,
   the merged entries, the feature ranges and one batch's top-k;
6. gather_rows (K2), inside the attribution phase after its counted run,
   on the subject's clean top-k (2,432 tokens x 256 rows of a
   131,072 x 4,096 fp32 decoder): copy mode bit-exact against
   `W[idx]` and timed beside it, decode mode within a stated fp32 bound of
   its plain version, timed beside its bound and `embedding_bag`;
   then its splice mode (`splice_decode`, the attribution chunk's decode)
   equal bit for bit to the parent path (`gather_decode` of `reselect`'s
   lists + b_dec, cast to the splice's dtype) and within a stated bound of
   its plain version (equal bits on the rows it copies) on the full-width
   chunk of the 8 inside features, the chunk of the 8 outside ones, 1
   feature, 32 features on 256 tokens, a small k == width case and a small
   bf16 decoder; both chunks timed (median of 5) beside the parent path,
   the hit count, the two bound terms and `embedding_bag`;
7. attribution_path: the full 32-layer random LLaMA-3-8B-width subject
   (bf16, flash attention, LM head) and the 131,072-latent SAE with its
   decoder (saved, then loaded with `decoder=True`); `fast_attribution_maps`
   at layers.24 over one 2,432-token prompt, 16 features at feature_batch 8
   (8 from the clean top-k at the last position, 8 in no token's top-(k+1)
   pool); checks the launch counts, finite saliency, exact zeros for the 8
   outside features, and the fast path against the general path for 2
   features; then a masked run (2 prompts of 512, row 1 left-padded by 100)
   with exact zeros at the pad positions and the fast path against the
   general path for 2 features; one chunk is timed stage by stage
   (CUDA events) and once under torch.profiler;
8. a `kernels` JSON line, the card line, and the result line.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
FP32_FMAS = 33.5e12  # 67 TFLOP/s fp32 on the CUDA cores, H100 SXM data sheet
K3_ATOL = 2e-2
K3_RTOL = 2e-2
# K3 tolerance, |kernel - plain| <= atol + rtol * |plain|: both outputs are
# bf16 (one ulp is 2^-8 relative) and the kernel rounds the softmax weights
# to bf16 before the PV product (2^-9 relative each); the plain version keeps
# them in fp32.  The outputs are averages of N(0, 1) values, |o| < ~4.
K3_LSE_ATOL = 1e-4
# K3 logsumexp tolerance, |kernel - plain| <= 1e-4 on rows with a valid key
# (+inf on both sides on rows without one): each logit sums hd = 128 exact
# products of bf16 values in fp32, which the two sum in different orders
# (at most 128 * 2^-24 * sum |qs * k|, about 5e-5 here where the sum is
# about 7); a logsumexp moves by at most its logits' largest error, plus a
# few fp32 ulps of |lse| < 10 from exp2/log2 against exp/log.
K3_BWD_MAX_REL = 2e-2
K3_BWD_L2_REL = 1e-2
# K3 backward tolerance, per gradient: max |kernel - plain| <= 2e-2 * max
# |plain| and ||kernel - plain|| <= 1e-2 * ||plain||.  The outputs are bf16
# (2^-9 relative rounding), dk and dv of a kv head sum 4 query heads in bf16
# products, and the kernel rounds P and dS to bf16 as the A operand of the
# products that consume them (2^-9 relative a term) where the plain version
# keeps fp32; the sums run over up to 2,432 queries or keys.  Each side
# starts from its own forward: the kernel's o and lse against the plain
# version's, so a fault in the forward's lse shows here.
K3_BWD_ZERO = 1e-3
# A gradient that is 0 in exact arithmetic is held to max |kernel| <= 1e-3
# instead: at S = 1 the one key's P is 1, so dS = dP - D, two fp32 sums of
# the same 128 products of bf16 values (|do . v| < ~40 here) in different
# orders, and dq and dk are that rounding (under 1e-4) times k or qs; the
# plain version's are rounding too, so a relative bound would compare noise
# with noise.  Every other gradient here has max |plain| > 1.
ATTRIBUTION_L2_REL = 1e-3
# Fast against general attribution, ||fast - general|| <= 1e-3 * ||general||
# per feature: the two select the same top-k in the same order, decode it
# with the same deterministic kernel and run the same kernels row by row, so
# they can differ only where a library matmul picks another reduction order
# for another row count (F * B rows against B); one bf16 ulp (2^-8) at a few
# scattered elements stays well under the bound.


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around `iters`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_repeats(fn, repeats: int = 5) -> dict:
    """Median, min and max of `repeats` calls of time_ms(fn), and them all."""
    ts = sorted(time_ms(fn) for _ in range(repeats))
    return {"median": ts[len(ts) // 2], "min": ts[0], "max": ts[-1], "all": ts}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _counted_modules():
    from multimodal_sae_tpu_torch.ops import block_max, flash_attention, gather_rows

    return {
        "block_max": (block_max, "launches"),
        "flash_attention": (flash_attention, "launches"),
        "flash_attention_bwd_delta": (flash_attention, "bwd_delta_launches"),
        "flash_attention_bwd_dkdv": (flash_attention, "bwd_dkdv_launches"),
        "flash_attention_bwd_dq": (flash_attention, "bwd_dq_launches"),
        "gather_rows": (gather_rows, "launches"),
        "splice_decode": (gather_rows, "splice_launches"),
    }


def reset_kernel_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for module, attr in _counted_modules().values():
        setattr(module, attr, 0)


def kernel_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in _counted_modules().items()}


def phase_build() -> str:
    from multimodal_sae_tpu_torch import kernels

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    emit({"phase": "build", "card": card, "build_s": build_s, "built": sorted(logs)})
    return card


def _bits_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Raise unless bit-equal outside NaNs with NaN at the same places;
    returns the max |a - b| (0.0)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    ib = torch.int32 if a.dtype == torch.float32 else torch.int16
    if not (torch.equal(na, nb) and torch.equal(a.view(ib)[~na], b.view(ib)[~nb])):
        raise AssertionError("block_max differs from its plain version")
    return (a.float()[~na] - b.float()[~nb]).abs().max().item()


def phase_block_max(dev) -> dict:
    """K1 at the main path's two filter levels (level 1 over the 131,072
    latents at block 64, level 2 over the 16,384 candidates at block 8, fp32,
    8 x 2,048 tokens) and at bf16 block 128."""
    from multimodal_sae_tpu_torch.ops import block_max as bm

    gen = torch.Generator(device=dev).manual_seed(1)
    per_step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for n, w, block, dtype in (
        (16384, 131072, 64, torch.float32),
        (16384, 16384, 8, torch.float32),
        (4096, 131072, 128, torch.bfloat16),
    ):
        x = torch.randn(n, w, generator=gen, device=dev, dtype=torch.float32).to(dtype)
        x[1, 5] = float("nan")
        x[2, :block] = float("-inf")
        got = bm.block_max(x, block)
        ref = bm.block_max_plain(x, block)
        torch.cuda.synchronize()
        err = _bits_err(got, ref)
        if not torch.isnan(got[1, 0]) or got[2, 0] != float("-inf"):
            raise AssertionError("block_max lost a NaN or an -inf block")
        kernel_ms = time_ms(lambda: bm.block_max(x, block))
        plain_ms = time_ms(lambda: bm.block_max_plain(x, block))
        library_ms = time_ms(lambda: torch.amax(x.view(n, w // block, block), dim=-1))
        bound_ms = (n * w + n * w // block) * x.element_size() / HBM_BYTES_PER_S * 1e3
        emit({
            "phase": "block_max", "shape": [n, w], "block": block,
            "dtype": str(dtype).replace("torch.", ""), "bitexact": True,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
        })
        if dtype == torch.float32:  # the main path's two calls per step
            for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bound_ms", bound_ms)):
                per_step[key] += val
        per_step["max_abs_err"] = max(per_step["max_abs_err"], err)
        del x, got, ref
    for block in bm.BLOCKS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(64, 16384, generator=gen, device=dev, dtype=torch.float32).to(dtype)
            x[3, 1000] = float("nan")
            _bits_err(bm.block_max(x, block), bm.block_max_plain(x, block))
    emit({"phase": "block_max_blocks", "shape": [64, 16384], "blocks": list(bm.BLOCKS),
          "dtypes": ["float32", "bfloat16"], "bitexact": True})
    torch.cuda.empty_cache()
    return per_step


def _check_attention(fa, q, k, v, pad_mask, scale, what) -> float:
    got = fa.flash_attention(q, k, v, pad_mask, scale)
    ref = fa.flash_attention_plain(q, k, v, pad_mask, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention gave non-finite output at {what}")
    err = (got.float() - ref.float()).abs()
    if not bool((err <= K3_ATOL + K3_RTOL * ref.float().abs()).all()):
        raise AssertionError(f"flash_attention off by {err.max().item()} at {what}")
    return err.max().item()


def phase_flash_attention(dev) -> dict:
    """K3 at LLaMA-3-8B's attention shape on the main path (B=8, H=32,
    kvH=8, S=2048, hd=128, bf16), unmasked (the main path's call) and with
    row 0 left-padded by 100; then edge shapes, all rows compared."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    B, H, kvH, S, hd = 8, 32, 8, 2048, 128
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    kr = k.repeat_interleave(H // kvH, dim=1)
    vr = v.repeat_interleave(H // kvH, dim=1)
    result = {"max_abs_err": 0.0}
    for padded in (False, True):
        pad_mask, real = None, torch.ones(B, S, dtype=torch.bool, device=dev)
        sdpa_mask = None
        if padded:
            real[0, :100] = False
            pad_mask = real.to(torch.int32)
            sdpa_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril() & real[:, None, None, :]
            sdpa_mask[0, :, :100, 0] = True  # SDPA needs a key per row; timing only
        err = _check_attention(fa, q, k, v, pad_mask, scale, f"main shape, padded={padded}")
        # The work this data needs: causal (query, key) pairs with a valid
        # key, 4 * hd operations each (QK^T and PV); q, k, v read, o written.
        pairs = torch.tril(torch.ones(S, S, device=dev))[None] * real[:, None, :].float()
        flops = 4.0 * hd * H * pairs.sum().item()
        nbytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2
        repeats = time_repeats(lambda: fa.flash_attention(q, k, v, pad_mask, scale))
        line = {
            "phase": "flash_attention", "shape": [B, H, kvH, S, hd], "padded": padded,
            "max_abs_err": err, "atol": K3_ATOL, "rtol": K3_RTOL,
            "kernel_ms": repeats["median"], "kernel_ms_repeats": repeats,
            "tflops": flops / repeats["median"] / 1e9,
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, pad_mask, scale), iters=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=sdpa_mask, is_causal=sdpa_mask is None, scale=scale)),
            "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
        }
        if not padded:
            line["resources"] = {hd_: fa.fwd_resources(hd_) for hd_ in (128, 64)}
        emit(line)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if not padded:
            result.update({key: line[key] for key in ("plain_ms", "library_ms", "bound_ms", "bound_by")})
            result["ms"] = line["kernel_ms"]
    del q, k, v, kr, vr
    # Edges: one token, ragged tiles, kvH = H and kvH = 1, hd 64, rows of
    # pads only, pad queries past one 64-row tile.
    edges = ((1, 2, 2, 1, 128, None), (2, 4, 1, 65, 128, [0, 30]), (1, 8, 2, 130, 64, [129]),
             (3, 4, 4, 64, 128, [0, 63, 10]), (2, 2, 1, 17, 64, [17, 3]), (1, 4, 2, 300, 128, [150]))
    for B_, H_, kvH_, S_, hd_, pads in edges:
        q = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        pad_mask = None
        if pads is not None:
            pad_mask = (torch.arange(S_, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]).int()
        err = _check_attention(fa, q, k, v, pad_mask, hd_ ** -0.5, (B_, H_, kvH_, S_, hd_, pads))
        result["max_abs_err"] = max(result["max_abs_err"], err)
    emit({"phase": "flash_attention_edges", "cases": [list(e[:5]) for e in edges],
          "max_abs_err": result["max_abs_err"], "atol": K3_ATOL, "rtol": K3_RTOL})
    torch.cuda.empty_cache()
    return result


def _grad_errors(got: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    """Hold one gradient of the K3 backward against its plain version (a
    gradient that is 0 in exact arithmetic against K3_BWD_ZERO)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention_bwd gave non-finite {what}")
    diff = got.float() - ref.float()
    out = {"max_abs_err": diff.abs().max().item(), "max_abs_plain": ref.float().abs().max().item()}
    if out["max_abs_plain"] <= K3_BWD_ZERO:
        out["max_abs_kernel"] = got.float().abs().max().item()
        if not out["max_abs_kernel"] <= K3_BWD_ZERO:
            raise AssertionError(f"flash_attention_bwd {what} off: {out}, 0 expected")
        return out
    out["l2_rel"] = (diff.norm() / ref.float().norm()).item()
    if not (out["max_abs_err"] <= K3_BWD_MAX_REL * out["max_abs_plain"] and out["l2_rel"] <= K3_BWD_L2_REL):
        raise AssertionError(f"flash_attention_bwd {what} off: {out}")
    return out


def _check_bwd_chain(fa, q, k, v, pad_mask, do, scale, what) -> dict:
    """The kernels' chain (forward with lse, then the backward on its o and
    lse) against the plain pair's, each from its own forward; a second
    backward on the same inputs must give the same bits, and dq must be
    exactly 0 on rows without a valid key."""
    o, lse = fa.flash_attention_fwd(q, k, v, pad_mask, scale, need_lse=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, pad_mask, scale)
    torch.cuda.synchronize()
    lse_err = _check_lse(lse, lse_ref, what)
    o_err = (o.float() - o_ref.float()).abs()
    if not bool((o_err <= K3_ATOL + K3_RTOL * o_ref.float().abs()).all()):
        raise AssertionError(f"flash_attention off by {o_err.max().item()} at {what}")
    got = fa.flash_attention_bwd(q, k, v, pad_mask, o, lse, do, scale)
    again = fa.flash_attention_bwd(q, k, v, pad_mask, o, lse, do, scale)
    ref = fa.flash_attention_bwd_plain(q, k, v, pad_mask, o_ref, lse_ref, do, scale)
    torch.cuda.synchronize()
    errors = {name: _grad_errors(a, b, f"{name} at {what}") for name, a, b in zip(("dq", "dk", "dv"), got, ref)}
    if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd: two calls differ at {what}")
    no_key = torch.isinf(lse)  # (B, H, S): rows without a valid key
    if bool(got[0][no_key].any()):
        raise AssertionError(f"flash_attention_bwd: dq not 0 on rows without a valid key at {what}")
    return {"lse_max_abs_err": lse_err, "lse_inf_rows": int(no_key.sum()), "o_max_abs_err": o_err.max().item(),
            "errors": errors, "deterministic": True}


def _check_lse(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Hold the forward's logsumexp against the plain version's: +inf at the
    same rows (those without a valid key), within K3_LSE_ATOL elsewhere."""
    inf = torch.isinf(ref)
    if torch.isnan(got).any() or not torch.equal(torch.isinf(got), inf) or bool((got[inf] < 0).any()):
        raise AssertionError(f"flash_attention lse: non-finite rows differ from the plain version's at {what}")
    err = (got[~inf] - ref[~inf]).abs().max().item()
    if not err <= K3_LSE_ATOL:
        raise AssertionError(f"flash_attention lse off by {err} at {what}")
    return err


def phase_flash_attention_bwd(dev) -> dict:
    """The K3 forward and backward at the attribution suffix's attention
    shape (H=32, kvH=8, S=2,432, hd=128, bf16): the kernels' chain (forward
    with lse, then backward on its o and lse) against the plain pair's at
    B=2 (the plain versions build (B, 32, S, S) fp32 tensors), unmasked and
    with row 0 left-padded by 300; then timed at B=8, the suffix's feature
    chunk."""
    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    H, kvH, S, hd = 32, 8, 2432, 128
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(B):
        q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        return q, k, v, do

    result = {"max_abs_err": 0.0}
    q, k, v, do = inputs(2)
    for pad in (0, 300):
        pad_mask, do_ = None, do
        if pad:
            real = torch.ones(2, S, dtype=torch.bool, device=dev)
            real[0, :pad] = False
            pad_mask = real.to(torch.int32)
            # Rows without a valid key (row 0's leading pads) are read by no
            # caller, so their dO is 0 on every path; the kernel's contract
            # (dq = 0 there, nothing added to dk, dv) holds the plain
            # version's only under that condition.
            do_ = do * real[:, None, :, None]
        line = _check_bwd_chain(fa, q, k, v, pad_mask, do_, scale, f"(2, {H}, {kvH}, {S}, {hd}), left pad {pad}")
        result["max_abs_err"] = max([result["max_abs_err"]] + [e["max_abs_err"] for e in line["errors"].values()])
        emit({"phase": "flash_attention_bwd_check", "shape": [2, H, kvH, S, hd], "left_pad_row0": pad, **line,
              "lse_atol": K3_LSE_ATOL, "max_rel": K3_BWD_MAX_REL, "l2_rel": K3_BWD_L2_REL})
        torch.cuda.empty_cache()
    del q, k, v, do
    torch.cuda.empty_cache()

    # Edges: one token, ragged tiles (17, 65, 130, 300), kvH = H and kvH = 1,
    # hd 64, left pads past one 64-row tile; dO zero on rows without a key.
    edges = ((1, 2, 2, 1, 128, None), (2, 4, 1, 17, 64, [0, 5]), (2, 4, 1, 65, 128, [0, 30]),
             (1, 8, 2, 130, 64, [100]), (2, 4, 4, 300, 128, [150, 0]), (1, 4, 2, 300, 64, None))
    edge_errors = {}
    for B_, H_, kvH_, S_, hd_, pads in edges:
        q_ = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        k_ = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        v_ = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        do_ = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        pad_mask = None
        if pads is not None:
            real = torch.arange(S_, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]
            pad_mask = real.int()
            do_ = do_ * real[:, None, :, None]
        what = str((B_, H_, kvH_, S_, hd_, pads))
        line = _check_bwd_chain(fa, q_, k_, v_, pad_mask, do_, hd_ ** -0.5, what)
        edge_errors[what] = {name: e["max_abs_err"] for name, e in line["errors"].items()}
        result["max_abs_err"] = max([result["max_abs_err"]] + list(edge_errors[what].values()))
    emit({"phase": "flash_attention_bwd_edges", "max_abs_err": edge_errors, "deterministic": True,
          "max_rel": K3_BWD_MAX_REL, "l2_rel": K3_BWD_L2_REL, "zero_atol": K3_BWD_ZERO})

    B = 8
    q, k, v, do = inputs(B)
    o, lse = fa.flash_attention_fwd(q, k, v, None, scale, need_lse=True)
    kernel_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, None, o, lse, do, scale))
    forward = time_repeats(lambda: fa.flash_attention_fwd(q, k, v, None, scale, need_lse=True))
    forward_library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    delta, qs = fa.bwd_delta(q, o, do, scale)
    delta_ms = time_ms(lambda: fa.bwd_delta(q, o, do, scale))
    dkdv_ms = time_ms(lambda: fa.bwd_dkdv(qs, k, v, None, lse, do, delta))
    dq_ms = time_ms(lambda: fa.bwd_dq(qs, k, v, None, lse, do, delta, scale))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, o, lse, do, scale), iters=2, warmup=1)
    # SDPA's backward alone (its forward outside the timing) on the same
    # kvH = 8 tensors with enable_gqa, so it too sums dk and dv over each
    # group; and, for comparison, with k and v repeated to H heads (dk and
    # dv then left at H heads).
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale, enable_gqa=True)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    kr = k.repeat_interleave(H // kvH, dim=1).requires_grad_()
    vr = v.repeat_interleave(H // kvH, dim=1).requires_grad_()
    out_r = torch.nn.functional.scaled_dot_product_attention(qg, kr, vr, is_causal=True, scale=scale)
    repeat_ms = time_ms(lambda: torch.autograd.grad(out_r, (qg, kr, vr), do, retain_graph=True))
    # The work: 5 products of 2 * hd operations per causal (query, key)
    # pair (the dK/dV kernel runs 4 of them, the dQ kernel 3); q, o, do, dq
    # and k, v, dk, dv moved once, lse read.  The forward: 2 products (4 * hd
    # per pair); q, k, v read, o and lse written.
    pairs = B * H * S * (S + 1) / 2
    nbytes = (4 * B * H * S * hd + 4 * B * kvH * S * hd) * 2 + B * H * S * 4
    flops = 10 * hd * pairs
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    fwd_flops = 4 * hd * pairs
    fwd_bytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2 + B * H * S * 4
    line = {
        "phase": "flash_attention_bwd", "shape": [B, H, kvH, S, hd], "kernel_ms": kernel_ms,
        "delta_ms": delta_ms, "dkdv_ms": dkdv_ms, "dq_ms": dq_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "library_repeat_kv_ms": repeat_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
        # The D pass reads q, o and do and writes qs and delta.
        "delta_bound_ms": (4 * B * H * S * hd * 2 + B * H * S * 4) / HBM_BYTES_PER_S * 1e3,
        "dkdv_bound_ms": 8 * hd * pairs / BF16_FLOPS * 1e3, "dq_bound_ms": 6 * hd * pairs / BF16_FLOPS * 1e3,
        "tflops": flops / kernel_ms / 1e9,
        "dkdv_tflops": 8 * hd * pairs / dkdv_ms / 1e9, "dq_tflops": 6 * hd * pairs / dq_ms / 1e9,
        "resources": fa.bwd_resources(hd),
        "forward_with_lse_ms": forward["median"], "forward_with_lse_ms_repeats": forward,
        "forward_with_lse_tflops": fwd_flops / forward["median"] / 1e9,
        "forward_with_lse_library_ms": forward_library_ms,
        "forward_with_lse_bound_ms": max(fwd_flops / BF16_FLOPS, fwd_bytes / HBM_BYTES_PER_S) * 1e3,
    }
    emit(line)
    del q, k, v, do, o, lse, delta, qs, qg, kg, vg, out, kr, vr, out_r
    torch.cuda.empty_cache()
    result.update({"ms": kernel_ms, **{key: line[key] for key in ("plain_ms", "library_ms", "bound_ms", "bound_by")}})
    return result


def _check_topk_as_sets(latents: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The port's top-k against `torch.topk` on the same latents: equal value
    multisets, and equal index sets up to ties at the k-th value."""
    ref_v, ref_i = torch.topk(latents, k, dim=-1)
    if not torch.equal(torch.sort(vals, dim=-1, descending=True).values, ref_v):
        raise AssertionError("top-k values differ from torch.topk")
    kth = ref_v[:, -1:]
    ref_set = torch.zeros_like(latents, dtype=torch.bool).scatter_(1, ref_i, True)
    got_set = torch.zeros_like(latents, dtype=torch.bool).scatter_(1, idx.long(), True)
    if bool(((ref_set != got_set) & (latents != kth)).any()):
        raise AssertionError("top-k index set differs from torch.topk beyond k-th-value ties")


def phase_cache_path(dev, card: str) -> dict:
    """The cache path at LLaMA-3-8B width (random bf16 weights, depth cut to
    the 25 layers hookpoint layers.24 reads) and the released SAE's width
    (131,072 latents, k=256, fp32), through the entry points a user calls."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features import FeatureCache
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.ops import top_k
    from multimodal_sae_tpu_torch.sae import Sae, pre_acts
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    setup(dev)
    n_batches, batch_size, ctx_len, n_splits, hook = 4, 8, 2048, 128, "layers.24"
    seconds = {}
    t0 = time.perf_counter()
    cfg = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0

    class CountingCache(FeatureCache):
        """Counts the top-k values above the extraction threshold that the
        host step receives (the number of entries the splits must hold)."""

        above = 0

        def _host_step(self, dev_out, batch_number, n_rows):
            for vals, _idx, event in dev_out.values():
                event.synchronize()
                self.above += int((vals.abs() > 1e-5).sum())
            super()._host_step(dev_out, batch_number, n_rows)

    rng = np.random.default_rng(0)
    rows = [{"input_ids": rng.integers(0, cfg.vocab_size, size=ctx_len)}
            for _ in range(n_batches * batch_size)]
    batch0 = {"input_ids": np.stack([r["input_ids"] for r in rows[:batch_size]])}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=False, seed=0, device=dev) \
            .save_to_disk(os.path.join(tmp, "saes", hook))
        saes = load_saes(os.path.join(tmp, "saes"), device=dev)
        sae = saes[hook]
        torch.cuda.synchronize()
        seconds["init_sae_save_load"] = time.perf_counter() - t0

        # Warm-up (cuBLAS handles, allocator) outside the counted run.
        t0 = time.perf_counter()
        h = model.capture(batch0, [hook])[hook]
        top_k(pre_acts(sae.params, h.reshape(-1, h.shape[-1])), sae.cfg.k, assume_finite=True)
        torch.cuda.synchronize()
        seconds["warmup"] = time.perf_counter() - t0
        del h

        save_dir = os.path.join(tmp, "cache")
        fc = CountingCache(lambda b: model.capture(b, [hook]), saes, batch_size=batch_size)
        fc.enable_streaming(save_dir, n_splits=n_splits)
        torch.cuda.reset_peak_memory_stats()
        # Collect garbage before each timed run, so that no collection pass
        # (a long one once the profiler's events are garbage) lands inside it.
        gc.collect()
        reset_kernel_counts()
        t0 = time.perf_counter()
        fc.run(ctx_len, rows, progress=False)
        torch.cuda.synchronize()
        seconds["run"] = time.perf_counter() - t0
        launches = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expected = {"block_max": 2 * n_batches, "flash_attention": 25 * n_batches,
                    "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
                    "flash_attention_bwd_dq": 0, "gather_rows": 0, "splice_decode": 0}
        if launches != expected:
            raise AssertionError(f"kernel launches {launches} over {n_batches} batches, expected {expected}")
        t0 = time.perf_counter()
        fc.save_splits(n_splits, save_dir)
        fc.concate_safetensors(n_splits, save_dir)
        seconds["save_and_merge"] = time.perf_counter() - t0

        module_dir = os.path.join(save_dir, hook)
        splits = sorted(
            (f for f in os.listdir(module_dir) if f.endswith(".safetensors")),
            key=lambda f: int(f.split("_")[0]),
        )
        if len(splits) != n_splits or any(f.startswith("Rank") for f in splits):
            raise AssertionError(f"expected {n_splits} merged splits, found {splits[:3]}...")
        n_entries = 0
        locs_all, acts_all = [], []
        for f in splits:
            start, end = (int(x) for x in f[: -len(".safetensors")].split("_"))
            data = load_file(os.path.join(module_dir, f))
            locs, acts = data["locations"].numpy(), data["activations"].numpy()
            feats = locs[:, 2]
            if len(feats) and (feats.min() < start or feats.max() > end):
                raise AssertionError(f"split {f} holds features outside [{start}, {end}]")
            if not os.path.exists(os.path.join(module_dir, f.replace(".safetensors", ".featidx"))):
                raise AssertionError(f"split {f} has no .featidx sidecar")
            n_entries += len(acts)
            locs_all.append(locs)
            acts_all.append(acts)
        if n_entries != fc.above:
            raise AssertionError(f"merged splits hold {n_entries} entries, top-k gave {fc.above} above 1e-5")
        locs = np.concatenate(locs_all)
        if not ((locs[:, 2] >= 0).all() and (locs[:, 2] < 131072).all()
                and (locs[:, 0] < n_batches * batch_size).all() and (locs[:, 1] < ctx_len).all()):
            raise AssertionError("merged locations out of range")
        acts = np.concatenate(acts_all)
        if not (np.isfinite(acts).all() and (np.abs(acts) > 1e-5).all()):
            raise AssertionError("merged activations non-finite or under the threshold")

    # Batch 0 again, stage by stage: its top-k against torch.topk as sets.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    h = model.capture(batch0, [hook])[hook]
    ev[1].record()
    latents = pre_acts(sae.params, h.reshape(-1, h.shape[-1]))
    ev[2].record()
    vals, idx = top_k(latents, sae.cfg.k, assume_finite=True)
    ev[3].record()
    torch.cuda.synchronize()
    _check_topk_as_sets(latents, vals, idx, sae.cfg.k)
    del latents

    tokens = n_batches * batch_size * ctx_len
    emit({
        "phase": "cache_path", "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook,
        "batches": n_batches, "batch_size": batch_size, "ctx_len": ctx_len, "tokens": tokens,
        "tokens_per_s": tokens / seconds["run"], "seconds": seconds,
        "stage_ms_batch0": {"subject_forward": ev[0].elapsed_time(ev[1]),
                            "encode": ev[1].elapsed_time(ev[2]),
                            "top_k": ev[2].elapsed_time(ev[3])},
        "launches": launches, "entries": n_entries, "n_splits": n_splits,
        "peak_gb": peak_gb, "card": card,
    })
    return {"launches": launches}


def check_gather_rows(W: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, chunk) -> dict:
    """K2 on the attribution prefix's clean top-k (`idx`, `vals`: tokens x k)
    of the decoder `W`: copy mode bit-exact against `W[idx]` on the first 128
    tokens' rows, decode mode within an fp32 bound of its plain version and
    deterministic, each timed; decode mode also at a chunk's re-selected
    top-k (`chunk` = (vals, idx) of 8 features stacked)."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N, k = idx.shape
    d = W.shape[1]
    flat = idx[:128].reshape(-1)
    got, ref = gr.gather_rows(W, flat), gr.gather_rows_plain(W, flat)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("gather_rows differs from W[idx]")
    # The 128 tokens' top-k repeat rows: the work reads each distinct row
    # once and writes every row.
    flat_long = flat.long()
    copy_distinct = torch.unique(flat).numel()
    copy = {"rows": flat.numel(), "distinct_rows": copy_distinct, "bitexact": True,
            "kernel_ms": time_ms(lambda: gr.gather_rows(W, flat)),
            "plain_ms": time_ms(lambda: gr.gather_rows_plain(W, flat)),
            "library_ms": time_ms(lambda: W[flat_long]),
            "bound_ms": ((copy_distinct + flat.numel()) * d * W.element_size() + flat.numel() * 4)
            / HBM_BYTES_PER_S * 1e3}
    del got, ref

    got, ref = gr.gather_decode(idx, vals, W), gr.gather_decode_plain(idx, vals, W)
    again = gr.gather_decode(idx, vals, W)
    torch.cuda.synchronize()
    # Both sum k fp32 products in their own order: each differs from the
    # exact sum by at most k * 2^-24 * sum_j |vals_j| * max |W|.
    err_bound = 2 * k * 2.0 ** -24 * vals.abs().sum(-1).max().item() * W.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= err_bound):
        raise AssertionError(f"gather_decode off by {err} (bound {err_bound})")
    if not torch.equal(got, again):
        raise AssertionError("gather_decode is not deterministic")
    del got, ref, again
    idx_long = idx.long()
    distinct = torch.unique(idx).numel()
    nbytes = distinct * d * 4 + N * d * 4 + N * k * 8
    decode = {
        "tokens": N, "k": k, "distinct_rows": distinct, "max_abs_err": err, "err_bound": err_bound,
        "deterministic": True, "kernel_ms": time_ms(lambda: gr.gather_decode(idx, vals, W)),
        "plain_ms": time_ms(lambda: gr.gather_decode_plain(idx, vals, W), iters=3),
        "library_ms": time_ms(lambda: F.embedding_bag(idx_long, W, per_sample_weights=vals, mode="sum")),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "no_reuse_gb": N * k * d * 4 / 1e9,
    }
    c_vals, c_idx = chunk
    c_distinct = torch.unique(c_idx).numel()
    decode_chunk = {
        "tokens": c_idx.shape[0], "distinct_rows": c_distinct,
        "kernel_ms": time_ms(lambda: gr.gather_decode(c_idx, c_vals, W)),
        "library_ms": time_ms(lambda: F.embedding_bag(c_idx.long(), W, per_sample_weights=c_vals, mode="sum")),
        "bound_ms": (c_distinct * d * 4 + c_idx.numel() * 8 + c_idx.shape[0] * d * 4) / HBM_BYTES_PER_S * 1e3,
        "no_reuse_gb": c_idx.numel() * d * 4 / 1e9,
    }
    emit({"phase": "gather_rows", "W": [W.shape[0], d], "dtype": "float32", "copy": copy,
          "decode_clean_topk": decode, "decode_chunk_of_8": decode_chunk})
    torch.cuda.empty_cache()
    return {"ms": decode["kernel_ms"], "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
            "bound_by": "bytes", "library_ms": decode["library_ms"], "max_abs_err": err}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ib = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ib), b.view(ib))


def _splice_parent(wide_idx, wide_vals, drop, k, W, b, clean):
    """The parent path: `reselect`'s (F·N, k) lists (the pool without the
    dropped entry, cut to k), K2's decode mode, + b in W's dtype, cast."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N = wide_idx.shape[0]
    rows = torch.arange(N, device=drop.device).repeat(drop.shape[0])
    vals, idx = gr.splice_lists(wide_idx, wide_vals, rows, drop.reshape(-1), k)
    return (gr.gather_decode(idx, vals, W) + b).to(clean.dtype), (vals, idx)


def _small_pool(gen, dev, N, width, kw, d, dtype):
    """A random decoder (width, d) of `dtype` with a bias, and N tokens'
    descending top-kw pools over it."""
    W = torch.randn(width, d, generator=gen, device=dev).to(dtype)
    b = torch.randn(d, generator=gen, device=dev).to(dtype)
    vals, idx = torch.topk(torch.rand(N, width, generator=gen, device=dev), kw)
    return W, b, idx.to(torch.int32), vals.to(dtype)


def _splice_err_bound(pool_vals, W, b, k, out_dtype) -> float:
    """Bound on |splice - plain| for one case.  Both sum at most k fp32
    products in their own order (check_gather_rows' bound, with the pool's
    sum of |vals| bounding any list's); then each rounds to W's dtype, adds b
    there and casts to the splice's dtype.  A rounding of unit roundoff u
    moves two values e apart to at most e + 2u·M apart, M their largest
    magnitude: the sum's bound plus max |b|."""
    s = pool_vals.float().abs().sum(-1).max().item() * W.float().abs().max().item()
    err = 2 * k * 2.0 ** -24 * s
    m = s + b.float().abs().max().item() + err
    if W.dtype == torch.bfloat16:  # the sum rounds to bf16, + b rounds in bf16; the cast is exact
        roundings = (2.0 ** -8, 2.0 ** -8)
    else:  # + b rounds in fp32, then the cast to a bf16 splice
        roundings = (2.0 ** -24,) + ((2.0 ** -8,) if out_dtype == torch.bfloat16 else ())
    return err + sum(2 * u * m for u in roundings)


def _check_splice_case(name, args) -> tuple:
    """One case of K2's splice mode: equal bits to the parent path (integer
    views), and against the plain version within `_splice_err_bound`, with
    equal bits on every copy row (drop >= k)."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    wide_idx, wide_vals, drop, k, W, b, clean = args
    got = gr.splice_decode(*args)
    ref, lists = _splice_parent(*args)
    plain = gr.splice_decode_plain(*args)
    torch.cuda.synchronize()
    if not _bits_equal(got, ref):
        raise AssertionError(f"splice_decode differs from the parent path on {name}")
    copy = (drop >= k).reshape(-1)
    if not _bits_equal(got[copy], plain[copy]):
        raise AssertionError(f"splice_decode's copy rows differ from the plain version's on {name}")
    err = (got.float() - plain.float()).abs().max().item() if got.numel() else 0.0
    bound = _splice_err_bound(wide_vals, W, b, k, clean.dtype)
    if not (bool(torch.isfinite(got).all()) and err <= bound):
        raise AssertionError(f"splice_decode off its plain version by {err} (bound {bound}) on {name}")
    hits = drop < k
    line = {"features": drop.shape[0], "tokens": drop.shape[1], "hit_pairs": int(hits.sum()),
            "hit_tokens": int(hits.any(0).sum()), "bit_equal_parent": True, "copy_rows_equal_plain": True,
            "max_abs_err_plain": err, "err_bound": bound}
    return line, lists


def check_splice_decode(step, inside, outside, W, b) -> dict:
    """K2's splice mode, each case against the parent path bit for bit and
    against its plain version within a stated bound (`_check_splice_case`):
    the attribution chunk of the 8 inside features (F = 8, the prompt's
    2,432 tokens, W_dec 131,072 x 4,096 fp32, bf16 splice), the chunk of the
    8 outside ones, F = 1, F = 32 on 256 tokens, a small k == width case
    (fp32 splice) and a small bf16 decoder (bf16 and fp32 splices).  Both
    chunks timed, median of 5, beside the parent path."""
    import torch.nn.functional as F_

    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    dev = W.device
    k = step.k
    clean = step.clean.reshape(-1, W.shape[1])
    pool_vals = step.wide_vals.to(W.dtype)
    cases = {"inside_F8": inside, "outside_F8": outside, "inside_F1": inside[:1]}
    sub = 256  # F = 32 (the auto width under 512 tokens) on the first 256 tokens
    cases["F32_on_256_tokens"] = step.wide_idx[sub - 1, :32].long().tolist()
    checked, out = {}, {}
    for name, feats in cases.items():
        n = sub if name.startswith("F32") else clean.shape[0]
        drop = step.drop_positions(torch.tensor(feats, device=dev))[:, :n]
        args = (step.wide_idx[:n], pool_vals[:n], drop, k, W, b, clean[:n])
        checked[name], lists = _check_splice_case(name, args)
        if name in ("inside_F8", "outside_F8"):
            out[name] = (args, lists)
        del lists
    gen = torch.Generator(device=dev).manual_seed(7)
    small = {  # name: (N, width, k, kw, d, W dtype, splice dtype, features)
        "k_equals_width": (64, 256, 256, 256, 512, torch.float32, torch.float32, 4),
        "bf16_decoder": (300, 4096, 32, 33, 1024, torch.bfloat16, torch.bfloat16, 8),
        "bf16_decoder_fp32_splice": (300, 4096, 32, 33, 1024, torch.bfloat16, torch.float32, 8),
    }
    for name, (n, width, k_, kw, d, wt, ct, F) in small.items():
        W_, b_, idx, vals = _small_pool(gen, dev, n, width, kw, d, wt)
        clean_ = (gr.gather_decode(idx[:, :k_], vals[:, :k_], W_) + b_).to(ct)
        # Features at pool positions 0, k_ - 1, kw - 1 of some tokens, and 1 absent.
        feats = [int(idx[0, 0]), int(idx[1, k_ - 1]), int(idx[2, kw - 1])]
        in_pool = torch.zeros(width, dtype=torch.bool, device=dev)
        in_pool[idx.long().reshape(-1)] = True
        feats += torch.nonzero(~in_pool).reshape(-1)[:1].tolist()
        feats = (feats * F)[:F]
        drop = gr.drop_positions(idx, torch.tensor(feats, device=dev))
        checked[name], _ = _check_splice_case(name, (idx, vals, drop, k_, W_, b_, clean_))
        checked[name].update({"width": width, "k": k_, "k_wide": kw, "d": d,
                              "W": str(wt).replace("torch.", ""), "splice": str(ct).replace("torch.", "")})
    max_err = max(c["max_abs_err_plain"] for c in checked.values())
    emit({"phase": "splice_decode_check", "cases": checked})

    timed = {}
    d = W.shape[1]
    for name, (args, (vals, idx)) in out.items():
        wide_idx, wide_vals, drop = args[:3]
        feats_t = torch.tensor(cases[name], device=dev)
        F, N = drop.shape
        kernel = time_repeats(lambda: gr.splice_decode(*args))
        parent_kernel = time_repeats(lambda: gr.gather_decode(idx, vals, W))
        parent_path = time_repeats(lambda: (gr.gather_decode(*step.reselect(feats_t)[::-1], W) + b).to(clean.dtype))
        new_path = time_repeats(lambda: gr.splice_decode(
            wide_idx, wide_vals, step.drop_positions(feats_t), k, W, b, clean))
        drop_ms = time_ms(lambda: step.drop_positions(feats_t))
        plain_ms = time_ms(lambda: gr.splice_decode_plain(*args), iters=2, warmup=1)
        library_ms = time_ms(lambda: F_.embedding_bag(idx.long(), W, per_sample_weights=vals, mode="sum"))
        hits = drop < k
        hit_pairs, hit_tokens = int(hits.sum()), hits.any(0)
        distinct = torch.unique(wide_idx[hit_tokens]).numel() if bool(hit_tokens.any()) else 0
        # The kernel reads a token's pool only where the token has a hit.
        nbytes = (F * N * d * clean.element_size() + N * d * clean.element_size() + F * N * 4
                  + int(hit_tokens.sum()) * wide_idx.shape[1] * (4 + W.element_size()) + d * W.element_size()
                  + distinct * d * W.element_size())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fma_ms = hit_pairs * k * d / FP32_FMAS * 1e3
        timed[name] = {
            "features": F, "tokens": N, "hit_pairs": hit_pairs, "hit_tokens": int(hit_tokens.sum()),
            "distinct_rows_of_hit_tokens": distinct,
            "kernel_ms": kernel["median"], "kernel_ms_repeats": kernel,
            "parent_kernel_ms": parent_kernel["median"], "parent_kernel_ms_repeats": parent_kernel,
            "parent_path_ms": parent_path["median"], "new_path_ms": new_path["median"],
            "drop_positions_ms": drop_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_bytes_ms": bytes_ms, "bound_fma_ms": fma_ms, "bound_ms": max(bytes_ms, fma_ms),
            "bound_by": "operations" if fma_ms > bytes_ms else "bytes",
        }
    emit({"phase": "splice_decode", "W": [W.shape[0], d], "dtype": str(W.dtype).replace("torch.", ""),
          "splice": str(clean.dtype).replace("torch.", ""), "max_abs_err_plain": max_err, "chunks": timed})
    torch.cuda.empty_cache()
    inside_line = timed["inside_F8"]
    return {"ms": inside_line["kernel_ms"], "plain_ms": inside_line["plain_ms"],
            "bound_ms": inside_line["bound_ms"], "bound_by": inside_line["bound_by"],
            "library_ms": inside_line["library_ms"], "max_abs_err": max_err}


STAGES = ("reselect", "decode", "forward", "backward", "saliency")


def time_stages(step, feats: torch.Tensor) -> dict:
    """Device milliseconds of each stage of one attribution chunk (CUDA
    events at the step's stage marks)."""
    marks = {"start": torch.cuda.Event(enable_timing=True)}

    def mark(stage):
        marks[stage] = torch.cuda.Event(enable_timing=True)
        marks[stage].record()

    marks["start"].record()
    step(feats, mark=mark)
    torch.cuda.synchronize()
    names = ("start",) + STAGES
    out = {stage: marks[a].elapsed_time(marks[stage]) for a, stage in zip(names, STAGES)}
    out["total"] = marks["start"].elapsed_time(marks[STAGES[-1]])
    return out


KERNEL_GROUPS = (
    ("flash_attention_bwd", ("dkdv_kernel", "dq_kernel", "delta_kernel")),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("splice_decode", ("splice_decode_kernel",)),
    ("gather_rows", ("gather_decode_kernel", "gather_rows_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
)


def profile_chunk(step, feats: torch.Tensor) -> dict:
    """One attribution chunk under torch.profiler: device time by kernel
    group and the device's busy share of the chunk's wall time.  Reports
    null where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(feats)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if str(getattr(e, "device_type", "")).endswith("CUDA") and us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(kernels.values())
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels.items():
        low = key.lower()
        group = next((name for name, parts in KERNEL_GROUPS if any(p in low for p in parts)), "other")
        groups[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "by_group_ms": groups if busy_ms else None,
            "top_kernels_ms": [[key[:80], ms] for key, ms in top]}


def _saliency(out: dict, hook: str) -> np.ndarray:
    sal = np.stack(out[hook])
    if not np.isfinite(sal).all():
        raise AssertionError("non-finite saliency")
    return sal


def phase_attribution_path(dev, card: str) -> dict:
    """Attribution patching at LLaMA-3-8B width (random bf16 weights, all 32
    layers, LM head) and the released SAE's width (131,072 latents, k=256,
    fp32, with its decoder), through `fast_attribution_maps`."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features.patching import (
        build_fast_attribution, fast_attribution_maps, general_attribution_maps, get_logit_diff,
    )
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae

    setup(dev)
    hook, S, fb, width = "layers.24", 2432, 8, 131072
    n_suffix = 32 - 25
    seconds = {}
    t0 = time.perf_counter()
    cfg = LlamaConfig(flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        Sae(4096, SaeConfig(num_latents=width, k=256), decoder=True, seed=0, device=dev) \
            .save_to_disk(os.path.join(tmp, hook))
        sae = Sae.load_from_disk(os.path.join(tmp, hook), decoder=True, device=dev)
        torch.cuda.synchronize()
        seconds["init_sae_save_load"] = time.perf_counter() - t0

    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, size=(1, S))}
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))

    # Outside the counted run: the prefix once, to choose the features and
    # feed K2's checks; one chunk as warm-up, then one timed stage by stage
    # and one under the profiler.  K2's checks (seconds of heavy card work)
    # run after the counted run, so that they do not precede it.
    t0 = time.perf_counter()
    step = build_fast_attribution(model, hook, sae, batch, metric)
    k = sae.cfg.k
    inside = step.wide_idx[-1, :8].long().tolist()  # the last position's 8 largest
    in_pool = torch.zeros(width, dtype=torch.bool, device=dev)
    in_pool[step.wide_idx.long().reshape(-1)] = True
    pool_free = torch.nonzero(~in_pool).squeeze(1).cpu().numpy()
    outside = sorted(rng.choice(pool_free, size=8, replace=False).tolist())
    feats = inside + outside
    chunk = torch.tensor(inside)
    step(chunk)  # warm-up
    torch.cuda.synchronize()
    seconds["prefix_and_warmup_chunk"] = time.perf_counter() - t0
    stage_ms = time_stages(step, chunk)
    profile = profile_chunk(step, chunk)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    alloc_before = torch.cuda.memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fast_attribution_maps(model, hook, sae, batch, metric, feats, feature_batch=fb, progress=False)
    torch.cuda.synchronize()
    seconds["run"] = time.perf_counter() - t0
    launches = kernel_counts()
    # The caching allocator's work inside the counted run: cudaMalloc calls
    # (new segments), frees back to the driver, and retries after a failed
    # cudaMalloc (which free cached blocks first).
    alloc_after = torch.cuda.memory_stats()
    alloc = {key: alloc_after.get(key, 0) - alloc_before.get(key, 0)
             for key in ("num_device_alloc", "num_device_free", "num_alloc_retries", "segment.all.allocated",
                         "segment.all.freed", "allocation.all.allocated")}
    alloc["reserved_gb_before"] = alloc_before.get("reserved_bytes.all.current", 0) / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k2 = check_gather_rows(sae.params["W_dec"], step.wide_idx[:, :k], step.wide_vals[:, :k],
                           step.reselect(torch.tensor(inside, device=dev)))
    splice = check_splice_decode(step, inside, outside, sae.params["W_dec"], sae.params["b_dec"])
    del step
    torch.cuda.empty_cache()
    chunks = len(feats) // fb
    # Prefix: 25 forward attentions, the two block-max levels of the
    # top-(k+1) pool, the clean decode; per chunk: one splice and the
    # suffix's 7 attentions forward and backward.
    expected = {"block_max": 2, "flash_attention": 25 + n_suffix * chunks,
                "flash_attention_bwd_delta": n_suffix * chunks, "flash_attention_bwd_dkdv": n_suffix * chunks,
                "flash_attention_bwd_dq": n_suffix * chunks, "gather_rows": 1, "splice_decode": chunks}
    if launches != expected:
        raise AssertionError(f"attribution kernel launches {launches}, expected {expected}")
    sal = _saliency(out, hook)  # (16, 1, S)
    if sal.shape != (len(feats), 1, S):
        raise AssertionError(f"saliency shape {sal.shape}")
    if np.any(sal[8:] != 0):
        raise AssertionError("saliency of a feature outside every top-k is not exactly 0")
    if not np.any(sal[:8] != 0):
        raise AssertionError("saliency of the in-top-k features is all 0")

    # The general path (full spliced forward and backward) for 2 features.
    t0 = time.perf_counter()
    general = general_attribution_maps(model, {hook: sae}, batch, metric, inside[:2], progress=False)
    torch.cuda.synchronize()
    seconds["general_2_features"] = time.perf_counter() - t0
    agreement = []
    for f, g in zip(sal[:2], general[hook]):
        rel = float(np.linalg.norm(f - g) / np.linalg.norm(g))
        agreement.append(rel)
        if not rel <= ATTRIBUTION_L2_REL:
            raise AssertionError(f"fast and general attribution differ: relative L2 {rel}")

    # Masked run: 2 prompts of 512 tokens, row 1 left-padded by 100.
    S2, pad = 512, 100
    mask = np.ones((2, S2), dtype=np.int64)
    mask[1, :pad] = 0
    batch2 = {"input_ids": rng.integers(0, cfg.vocab_size, size=(2, S2)), "attention_mask": mask}
    metric2 = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000], [3000, 4000]], device=dev))
    step2 = build_fast_attribution(model, hook, sae, batch2, metric2)
    feats2 = step2.wide_idx[S2 - 1, :4].long().tolist() + step2.wide_idx[2 * S2 - 1, :4].long().tolist()
    del step2
    gc.collect()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out2 = fast_attribution_maps(model, hook, sae, batch2, metric2, feats2, feature_batch=fb, progress=False)
    torch.cuda.synchronize()
    seconds["masked_run"] = time.perf_counter() - t0
    launches2 = kernel_counts()
    expected2 = {"block_max": 2, "flash_attention": 25 + n_suffix, "flash_attention_bwd_delta": n_suffix,
                 "flash_attention_bwd_dkdv": n_suffix, "flash_attention_bwd_dq": n_suffix, "gather_rows": 1,
                 "splice_decode": 1}
    if launches2 != expected2:
        raise AssertionError(f"masked attribution kernel launches {launches2}, expected {expected2}")
    sal2 = _saliency(out2, hook)  # (8, 2, 512)
    if np.any(sal2[:, 1, :pad] != 0):
        raise AssertionError("saliency at pad positions is not exactly 0")
    if not np.any(sal2[:, 1, pad:] != 0):
        raise AssertionError("saliency at row 1's real positions is all 0")
    # The general path on the masked batch for one feature of each row's
    # top-k (the fast path tiles the mask F times; the general path not).
    general2 = general_attribution_maps(model, {hook: sae}, batch2, metric2, [feats2[0], feats2[4]], progress=False)
    for f, g in zip(sal2[[0, 4]], general2[hook]):
        rel = float(np.linalg.norm(f - g) / np.linalg.norm(g))
        agreement.append(rel)
        if not rel <= ATTRIBUTION_L2_REL:
            raise AssertionError(f"fast and general attribution differ on the masked batch: relative L2 {rel}")

    emit({
        "phase": "attribution_path", "subject": "LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head",
        "sae": "4096 -> 131072 latents, k=256, fp32, decoder", "hookpoint": hook, "prompt_tokens": S,
        "features": len(feats), "feature_batch": fb, "seconds": seconds,
        "ms_per_feature": seconds["run"] * 1e3 / len(feats), "features_per_s": len(feats) / seconds["run"],
        "outside_chunks_ms": seconds["run"] * 1e3 - chunks * stage_ms["total"], "allocator": alloc,
        "chunk_stage_ms": stage_ms, "chunk_profile": profile, "launches": launches, "peak_gb": peak_gb,
        "outside_topk_exact_zero": True, "fast_vs_general_l2_rel": agreement[:2], "l2_rel_bound": ATTRIBUTION_L2_REL,
        "masked": {"prompts": 2, "tokens": S2, "left_pad_row1": pad, "features": len(feats2),
                   "launches": launches2, "pad_positions_exact_zero": True,
                   "fast_vs_general_l2_rel": agreement[2:]},
        "card": card,
    })
    return {"launches": {name: launches[name] + launches2[name] for name in launches}, "k2": k2,
            "splice": splice}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_build()
    k1 = phase_block_max(dev)
    k3 = phase_flash_attention(dev)
    k3_bwd = phase_flash_attention_bwd(dev)
    cache = phase_cache_path(dev, card)
    torch.cuda.empty_cache()
    attribution = phase_attribution_path(dev, card)
    runs = (cache["launches"], attribution["launches"])
    total = {name: sum(run[name] for run in runs) for name in runs[0]}
    k2, splice = attribution["k2"], attribution["splice"]
    bwd_launches = {part: total[f"flash_attention_bwd_{part}"] for part in ("delta", "dkdv", "dq")}
    kernels_line = {"kernels": [
        {"name": "block_max", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/block_max.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_topk.py:48",
         "launches": total["block_max"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": k1["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/flash_attention.cu",
         "replaces": "multimodal_sae_tpu/models/llama.py:341",
         "launches": total["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "multimodal_sae_tpu/models/llama.py:341 (jax flash_attention.py:1121 dkv, :1456 dq)",
         "launches": bwd_launches["delta"] + bwd_launches["dkdv"] + bwd_launches["dq"],
         "launches_by_kernel": bwd_launches, "max_abs_err": k3_bwd["max_abs_err"],
         "ms": k3_bwd["ms"], "plain_ms": k3_bwd["plain_ms"], "bound_ms": k3_bwd["bound_ms"],
         "bound_by": k3_bwd["bound_by"], "library_ms": k3_bwd["library_ms"]},
        {"name": "gather_rows", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/gather_rows.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_gather.py:50",
         "launches": total["gather_rows"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
        {"name": "splice_decode", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/gather_rows.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_gather.py:50",
         "launches": total["splice_decode"], "max_abs_err": splice["max_abs_err"],
         "ms": splice["ms"], "plain_ms": splice["plain_ms"], "bound_ms": splice["bound_ms"],
         "bound_by": splice["bound_by"], "library_ms": splice["library_ms"]},
    ]}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernels_line)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
