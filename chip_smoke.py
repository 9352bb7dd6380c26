#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`multimodal_sae_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and ends the run with a non-zero exit code:

1. build: print the card's name and power limit, build the CUDA kernels of
   `multimodal_sae_tpu_torch/csrc/` with nvcc for sm_90a (one process per
   source, in parallel);
2. block_max (K1) against its plain version, bit-exact, at the shapes of the
   text and image caches' two filter levels (16,384 and 9,360 tokens) and at
   bf16 block 128, then at every block it takes;
3. flash_attention (K3) against its plain version at LLaMA-3-8B's attention
   shape, unmasked and with one row left-padded by 100, each timed as the
   median, min and max of 5 repeats beside its bound, its TFLOP/s and SDPA
   (with the pad mask where there is one), with the forward kernel's
   registers, shared memory and blocks per SM at hd 128 and 64; then at the
   image cache's two shapes, (4, 32, 8, 2,341, 128) unmasked and
   (4, 32, 8, 2,929, 128) right-padded to valid lengths 2,341, 1,177, 2,329
   and 2,929, every row compared (pad queries included) and timed the same
   way; then at edge shapes, two of them right-padded with pads that end
   inside a 64-key tile;
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
   loader_path, in the cache path's directory, on its merged splits: a
   `FeatureDataset` filtered to 2,000 features drawn with a seed
   from those the cache holds (some under `min_examples`, skipped), loaded
   with `pool_max_activation_windows` on the cache's token rows and
   `sample`, sequentially and on LOADER_WORKERS threads, through the
   merge's `.featidx` sidecars; then 8 splits unfiltered, their sidecars
   removed, on the scan path (which heals them) and then through the
   sidecars; every record against an independent numpy reconstruction from
   the raw split (tokens and activations bit for bit), threaded equal to
   sequential, scan equal to sidecar, no kernel launched; smoke readings of
   seconds, records/s, entries/s and the host CPU's share per build;
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
   stats_path, after the attribution phase, on that subject's LM head and that SAE's
   decoder: `get_neighbors` for the loader's 2,000 features at k = 10, `logits` for
   the loader's records (a stub tokenizer), `PcaReducer.fit_sae_list` at
   the full decoder, the thin SVD of the decoder timed beside it; 16 features recomputed in float64 on the card
   (neighbour and top-token orders equal but for near-ties, cosines within
   STATS_ATOL), the two components orthonormal and their variance equal to
   the covariance's top two eigenvalues (float64); ms and peak memory per
   call; no kernel launched;
8. train_path: `SaeTrainer` at the README's command shape (131,072
   latents, k = 256, fp32, batch 8 x 2,048, grad_acc_steps 4,
   micro_acc_steps TRAIN_MICRO, lr_warmup_steps 0) on the 25-layer random
   LLaMA-3-8B-width subject (bf16, flash attention, layers.24), reading a
   uint32 `MemmapDataset`: eight batches (two optimizer steps, b_dec from
   the geometric median), `save` and `load_state` into a fresh trainer
   (parameters, moments, counters equal bit for bit), one batch on the
   resumed trainer and one with AuxK (half the latents made dead,
   micro_acc_steps AUXK_MICRO); checks finite losses, unit decoder rows
   after `accumulate`, the projected gradient orthogonal to the rows, the
   counters against the window's fired mask and K1's launches; times
   tokens/s, one batch's stages (CUDA events) and the peak memory; then
   the card's `accumulate` against the CPU's (d 4,096, 16,384 latents,
   1,024 tokens on an exact grid: equal masks, gradients within
   TRAIN_CPU_L2_REL), `forward(fast=False)` and its backward against the
   fast path at full width on 4,096 tokens (a counted run: K1, K2's decode
   and dvals modes), and K2's dvals mode against its plain version (equal
   bits twice, timed beside its bound);
9. image_cache_path: a random LLaVA-NeXT at llama3-llava-next-8b's widths
   (CLIP-L/336 tower, projector, LLaMA-3-8B text cut to the 25 layers
   model.layers.24 reads; bf16, flash attention) feeding the 131,072-latent
   SAE (saved, read back) through `FeatureImageCache` (BOS dropped, streaming
   splits, 128 of them) over 4 batches of 4 images of 480 x 640 (2,341
   tokens a row) and one of 4 geometries right-padded to 2,929, prepared
   here with seeded pixels (one array per image, so the tower runs once per
   image); checks the row lengths, the launch counts, the splits and their
   `.featidx` sidecars, every cached row against an independent top-k of
   its hidden (captured again after the counted run), and each image of the
   mixed batch alone against its padded row (equal bits); prints smoke
   readings of images/s, tokens/s and peak memory over the five batches,
   and one batch's stages (CUDA events);
10. a `kernels` JSON line, the card line, and the result line.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
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
TRAIN_MICRO = 1
AUXK_MICRO = 1
# micro_acc_steps of the training batches and of the AuxK batch: the least
# that fits (train_memory.py on an NVIDIA H100 80GB HBM3 at 700 W: peak
# 61.3 GB at 1 and 46.9 GB at 2 without AuxK, 72.5 GB at 1 with it).
UNIT_NORM_TOL = 1e-5
# Decoder rows after `accumulate`'s renorm: max |‖row‖ - 1| <= 1e-5 (each
# row is divided by its fp32 norm + eps, a few ulps from 1).
ORTHO_REL = 5e-4
# The projected decoder gradient g' against the unit rows w:
# max |g'_l . w_l| <= 5e-4 * max ‖g'_l‖.  Both the projection's dot and
# this one are fp32 sums of d = 4,096 products, each within d * 2^-24 =
# 2.4e-4 relative of exact.
TRAIN_CPU_L2_REL = 1e-4
# The card's `accumulate` against the CPU's on one chunk: every gradient
# within relative L2 1e-4 (fp32 matmuls and reductions summed in other
# orders; the renormalised decoders differ by ulps).  The inputs lie on a
# grid on which the encoder's products and sums are exact, so both sides'
# pre-activations, and with them every selection mask, are equal bit for bit.
FAST_SLOW_REL = 1e-4
# forward(fast=False) against the fast path on one full-width chunk: fvu
# within 1e-4 relative and each gradient within relative L2 1e-4 (the same
# selection, decoded and differentiated by other fp32 sums).
STATS_ATOL = 1e-5
# Neighbour cosines against float64 on the card: |fp32 - float64| <= 1e-5
# (each is an fp32 dot of two unit rows of d = 4,096, within about
# d * 2^-24 = 2.4e-4 in the worst case and ~1e-6 in practice).
STATS_NEAR_TIE = 2e-5
# A neighbour or top token may differ from the float64 order only where the
# two candidates' float64 values lie within 2e-5 (twice STATS_ATOL).
PCA_ORTHO = 1e-5
PCA_EV_REL = 1e-4
# PCA's two components: orthonormal within 1e-5; the variance along each
# (a float64 Rayleigh quotient of the decoder's covariance) within 1e-4
# relative of the covariance's top two eigenvalues (float64 eigvalsh).
LOADER_WORKERS = 4
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
        "decode_dvals": (gather_rows, "dvals_launches"),
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
    latents at block 64, level 2 over the 16,384 candidates at block 8, fp32),
    for the text cache's 8 x 2,048 tokens and the image cache's 9,360 (4
    images of 2,341 tokens less the BOS), and at bf16 block 128."""
    from multimodal_sae_tpu_torch.ops import block_max as bm

    gen = torch.Generator(device=dev).manual_seed(1)
    zero = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    per_step = {"text": dict(zero), "image": dict(zero)}
    max_abs_err = 0.0
    for n, w, block, dtype, step in (
        (16384, 131072, 64, torch.float32, "text"),
        (16384, 16384, 8, torch.float32, "text"),
        (9360, 131072, 64, torch.float32, "image"),
        (9360, 16384, 8, torch.float32, "image"),
        (4096, 131072, 128, torch.bfloat16, None),
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
        if step is not None:  # a main path's two calls per step
            for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bound_ms", bound_ms)):
                per_step[step][key] += val
        max_abs_err = max(max_abs_err, err)
        del x, got, ref
    for block in bm.BLOCKS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(64, 16384, generator=gen, device=dev, dtype=torch.float32).to(dtype)
            x[3, 1000] = float("nan")
            _bits_err(bm.block_max(x, block), bm.block_max_plain(x, block))
    emit({"phase": "block_max_blocks", "shape": [64, 16384], "blocks": list(bm.BLOCKS),
          "dtypes": ["float32", "bfloat16"], "bitexact": True})
    torch.cuda.empty_cache()
    return {**per_step["text"], "max_abs_err": max_abs_err, "image_step": per_step["image"]}


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
    row 0 left-padded by 100; then the image cache's two shapes (uniform,
    and right-padded); then edge shapes, left- and right-padded, all rows
    compared."""
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
    torch.cuda.empty_cache()
    # The image cache's two shapes: a uniform batch of 4 images of 2,341
    # tokens (no mask), and the mixed batch of 4 geometries right-padded to
    # 2,929 (valid lengths 2,341, 1,177, 2,329 and 2,929).
    result["image_shapes"] = [
        _attention_case(fa, gen, dev, 4, 32, 8, 2341, 128, None),
        _attention_case(fa, gen, dev, 4, 32, 8, 2929, 128, [2341, 1177, 2329, 2929]),
    ]
    result["max_abs_err"] = max([result["max_abs_err"]] + [c["max_abs_err"] for c in result["image_shapes"]])
    # Edges: one token, ragged tiles, kvH = H and kvH = 1, hd 64, rows of
    # pads only, pad queries past one 64-row tile; then right pads (valid
    # lengths) that end inside a 64-key tile.
    edges = ((1, 2, 2, 1, 128, None), (2, 4, 1, 65, 128, [0, 30]), (1, 8, 2, 130, 64, [129]),
             (3, 4, 4, 64, 128, [0, 63, 10]), (2, 2, 1, 17, 64, [17, 3]), (1, 4, 2, 300, 128, [150]))
    right_edges = ((3, 4, 2, 150, 128, [100, 150, 37]), (2, 8, 2, 200, 64, [130, 75]))
    right_err = 0.0
    for B_, H_, kvH_, S_, hd_, pads in edges + right_edges:
        q = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        pad_mask = None
        if pads is not None:
            bound = torch.tensor(pads, device=dev)[:, None]
            pos = torch.arange(S_, device=dev)[None, :]
            pad_mask = (pos < bound if (B_, H_, kvH_, S_, hd_, pads) in right_edges else pos >= bound).int()
        err = _check_attention(fa, q, k, v, pad_mask, hd_ ** -0.5, (B_, H_, kvH_, S_, hd_, pads))
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if (B_, H_, kvH_, S_, hd_, pads) in right_edges:
            right_err = max(right_err, err)
    result["right_pad_edges_max_abs_err"] = right_err
    emit({"phase": "flash_attention_edges", "cases": [list(e[:5]) for e in edges],
          "right_pad_cases": [list(e) for e in right_edges], "right_pad_max_abs_err": right_err,
          "max_abs_err": result["max_abs_err"], "atol": K3_ATOL, "rtol": K3_RTOL})
    torch.cuda.empty_cache()
    return result


def _attention_case(fa, gen, dev, B, H, kvH, S, hd, valid) -> dict:
    """K3 at one shape against its plain version on every row (pad queries
    included), timed (median of 5 repeats) beside its bound, the plain
    version and SDPA; `valid` gives each row's valid length (right pads), or
    None for no mask."""
    import torch.nn.functional as F

    scale = hd ** -0.5
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    real = torch.ones(B, S, dtype=torch.bool, device=dev)
    pad_mask = sdpa_mask = None
    if valid is not None:
        real = torch.arange(S, device=dev)[None, :] < torch.tensor(valid, device=dev)[:, None]
        pad_mask = real.to(torch.int32)
        sdpa_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril() & real[:, None, None, :]
    what = f"({B}, {H}, {kvH}, {S}, {hd}), valid lengths {valid}"
    err = _check_attention(fa, q, k, v, pad_mask, scale, what)
    torch.cuda.empty_cache()
    # The work this data needs: causal (query, key) pairs with a valid key,
    # 4 * hd operations each; q, k, v read, o written.
    pairs = (torch.tril(torch.ones(S, S, device=dev))[None] * real[:, None, :].float()).sum().item()
    flops = 4.0 * hd * H * pairs
    nbytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2
    repeats = time_repeats(lambda: fa.flash_attention(q, k, v, pad_mask, scale))
    line = {
        "phase": "flash_attention_image", "shape": [B, H, kvH, S, hd], "valid_lengths": valid,
        "max_abs_err": err, "atol": K3_ATOL, "rtol": K3_RTOL,
        "ms": repeats["median"], "kernel_ms_repeats": repeats, "tflops": flops / repeats["median"] / 1e9,
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, pad_mask, scale), iters=2, warmup=1),
        "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
    }
    if sdpa_mask is None:
        line["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    else:  # SDPA's masked kernels take k and v repeated to H heads
        kr, vr = (t.repeat_interleave(H // kvH, dim=1) for t in (k, v))
        line["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=sdpa_mask, scale=scale))
        del kr, vr
    emit(line)
    del q, k, v, sdpa_mask
    torch.cuda.empty_cache()
    return {key: val for key, val in line.items() if key not in ("phase", "kernel_ms_repeats", "atol", "rtol")}


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


def counting(cache_cls):
    """`cache_cls` counting the top-k values above the extraction threshold
    that its host step receives (the number of entries the splits must
    hold)."""

    class Counting(cache_cls):
        above = 0

        def _host_step(self, dev_out, batch_number, n_rows):
            for vals, _idx, event in dev_out.values():
                event.synchronize()
                self.above += int((vals.abs() > 1e-5).sum())
            super()._host_step(dev_out, batch_number, n_rows)

    return Counting


def check_splits(module_dir: str, n_splits: int, width: int) -> tuple:
    """The merged splits of one hookpoint: `n_splits` files, each with its
    features inside its range and a `.featidx` sidecar that reads back;
    returns every split's (locations, activations) concatenated."""
    from multimodal_sae_tpu_torch.features.split_index import read_index
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    splits = sorted((f for f in os.listdir(module_dir) if f.endswith(".safetensors")),
                    key=lambda f: int(f.split("_")[0]))
    if len(splits) != n_splits or any(f.startswith("Rank") for f in splits):
        raise AssertionError(f"expected {n_splits} merged splits, found {splits[:3]}...")
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
        index = read_index(os.path.join(module_dir, f), len(acts))
        if index is None or not np.array_equal(feats[np.asarray(index[0])], np.asarray(index[1])):
            raise AssertionError(f"split {f}'s .featidx does not read back its features")
        locs_all.append(locs)
        acts_all.append(acts)
    locs, acts = np.concatenate(locs_all), np.concatenate(acts_all)
    if not ((locs[:, 2] >= 0).all() and (locs[:, 2] < width).all()):
        raise AssertionError("merged feature indices out of range")
    if not (np.isfinite(acts).all() and (np.abs(acts) > 1e-5).all()):
        raise AssertionError("merged activations non-finite or under the threshold")
    return locs, acts


def phase_cache_path(dev, card: str, work_dir: str) -> dict:
    """The cache path at LLaMA-3-8B width (random bf16 weights, depth cut to
    the 25 layers hookpoint layers.24 reads) and the released SAE's width
    (131,072 latents, k=256, fp32), through the entry points a user calls.
    Writes under `work_dir`, which the caller removes; returns the merged
    cache's directory, hookpoint and token rows for the loader phase."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features import FeatureCache
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.ops import top_k
    from multimodal_sae_tpu_torch.sae import Sae, pre_acts

    setup(dev)
    n_batches, batch_size, ctx_len, n_splits, hook = 4, 8, 2048, 128, "layers.24"
    seconds = {}
    t0 = time.perf_counter()
    cfg = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0

    CountingCache = counting(FeatureCache)
    rng = np.random.default_rng(0)
    rows = [{"input_ids": rng.integers(0, cfg.vocab_size, size=ctx_len)}
            for _ in range(n_batches * batch_size)]
    batch0 = {"input_ids": np.stack([r["input_ids"] for r in rows[:batch_size]])}
    t0 = time.perf_counter()
    Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=False, seed=0, device=dev) \
        .save_to_disk(os.path.join(work_dir, "saes", hook))
    saes = load_saes(os.path.join(work_dir, "saes"), device=dev)
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

    save_dir = os.path.join(work_dir, "cache")
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
                "flash_attention_bwd_dq": 0, "gather_rows": 0, "splice_decode": 0, "decode_dvals": 0}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} over {n_batches} batches, expected {expected}")
    t0 = time.perf_counter()
    fc.save_splits(n_splits, save_dir)
    fc.concate_safetensors(n_splits, save_dir)
    seconds["save_and_merge"] = time.perf_counter() - t0

    locs, acts = check_splits(os.path.join(save_dir, hook), n_splits, 131072)
    n_entries = len(acts)
    if n_entries != fc.above:
        raise AssertionError(f"merged splits hold {n_entries} entries, top-k gave {fc.above} above 1e-5")
    if not ((locs[:, 0] < n_batches * batch_size).all() and (locs[:, 1] < ctx_len).all()):
        raise AssertionError("merged locations out of range")

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
    return {"launches": launches, "cache_dir": save_dir, "hook": hook,
            "tokens": np.stack([r["input_ids"] for r in rows])}


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
    a, b = a.detach(), b.detach()
    if not a.is_floating_point():
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
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
                "flash_attention_bwd_dq": n_suffix * chunks, "gather_rows": 1, "splice_decode": chunks,
                "decode_dvals": 0}
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
                 "splice_decode": 1, "decode_dvals": 0}
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
            "splice": splice, "model": model, "sae": sae}


TRAIN_STAGES = ("capture", "encode", "top_k", "masked_decode", "losses", "backward", "clip", "apply", "bookkeeping")


class StageMarks:
    """CUDA events at the trainer's stage marks; `ms()` sums the time of
    each stage (from the previous mark to its own) over one batch."""

    def __init__(self):
        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()
        self.on_apply = None

    def __call__(self, stage: str):
        if stage == "apply" and self.on_apply is not None:
            self.on_apply()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((stage, event))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for (_, a), (stage, b) in zip(self.events, self.events[1:]):
            out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        out["total"] = self.events[0][1].elapsed_time(self.events[-1][1])
        return out


def _trainer_state_equal(a, b, hook: str) -> bool:
    """Parameters, optimizer leaves and counters of two trainers equal bit
    for bit."""
    from multimodal_sae_tpu_torch.ops.adam import flatten_state

    pa, pb = a.saes[hook].params, b.saes[hook].params
    if set(pa) != set(pb) or not all(_bits_equal(pa[n], pb[n]) for n in pa):
        return False
    la, lb = flatten_state(a.opt_states[hook]), flatten_state(b.opt_states[hook])
    if len(la) != len(lb) or not all(_bits_equal(x, y) for x, y in zip(la, lb)):
        return False
    return (np.array_equal(a.num_tokens_since_fired[hook], b.num_tokens_since_fired[hook])
            and (a.global_step, a.opt_step) == (b.global_step, b.opt_step))


def _l2_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return ((got - ref).norm() / ref.norm()).item()


def check_accumulate_cpu(chunk: torch.Tensor, dev) -> dict:
    """The card's `accumulate` against the CPU's on one chunk (1,024 tokens
    of the subject's hidden states) at d 4,096 and 16,384 latents, k 256,
    AuxK on with every other latent dead.  Parameters and chunk lie on a
    grid (W_enc multiples of 2^-7 up to 2^-4, biases and inputs multiples
    of 2^-4 and 2^-11, inputs clamped to [-8, 8]) on which every product
    and partial sum of the encoder is exact in fp32, so the two devices'
    pre-activations agree bit for bit and the masks must be equal."""
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.ops.sparse_decode import topk_mask_decode
    from multimodal_sae_tpu_torch.sae import pre_acts
    from multimodal_sae_tpu_torch.train.trainer import accumulate

    d, L, k = chunk.shape[1], 16384, 256
    rng = np.random.default_rng(3)
    W_enc = rng.integers(-8, 9, size=(d, L)).astype(np.float32) / 2**7
    W_dec = rng.standard_normal((L, d)).astype(np.float32)
    host = {"W_enc": W_enc, "b_enc": rng.integers(-8, 9, size=L).astype(np.float32) / 2**11,
            "W_dec": W_dec, "b_dec": rng.integers(-4, 5, size=d).astype(np.float32) / 2**4}
    x = (chunk.float() * 16).round().clamp(-128, 128).cpu() / 16
    cfg = TrainConfig(sae=SaeConfig(num_latents=L, k=k), auxk_alpha=1 / 32)
    dead = torch.zeros(L, dtype=torch.bool)
    dead[::2] = True
    out = {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else torch.device("cpu")
        params = {n: torch.from_numpy(a.copy()).to(device).requires_grad_(True) for n, a in host.items()}
        t0 = time.perf_counter()
        fired, sums = accumulate(params, x.to(device), dead.to(device), cfg)
        mask = topk_mask_decode(pre_acts(params, x.to(device)).detach(), params["W_dec"].detach(), k)[2]
        if where == "cuda":
            torch.cuda.synchronize()
        out[where] = {"fired": fired.cpu(), "mask": mask.cpu(), "sums": {n: v.item() for n, v in sums.items()},
                      "grads": {n: p.grad.cpu() for n, p in params.items()}, "s": time.perf_counter() - t0}
        del params, fired, mask
    gpu, cpu = out["cuda"], out["cpu"]
    if not (torch.equal(gpu["mask"], cpu["mask"]) and torch.equal(gpu["fired"], cpu["fired"])):
        raise AssertionError("the card's selection or fired mask differs from the CPU's")
    rel = {n: _l2_rel(gpu["grads"][n], cpu["grads"][n]) for n in host}
    if not all(r <= TRAIN_CPU_L2_REL for r in rel.values()):
        raise AssertionError(f"the card's accumulate differs from the CPU's: relative L2 {rel}")
    line = {"tokens": x.shape[0], "d": d, "latents": L, "k": k, "masks_equal": True,
            "selected": int(gpu["mask"].sum()), "fired": int(gpu["fired"].sum()), "grad_l2_rel": rel,
            "l2_rel_bound": TRAIN_CPU_L2_REL, "sums_card": gpu["sums"], "sums_cpu": cpu["sums"],
            "seconds_card": gpu["s"], "seconds_cpu": cpu["s"]}
    torch.cuda.empty_cache()
    return line


def check_fast_vs_slow(params: dict, x: torch.Tensor, cfg) -> tuple:
    """`forward(fast=False)` (select_topk, then the sparse decode with its
    backward: K2's decode and dvals modes) against the fast path on one
    chunk at full width: fvu and each gradient, and each path's forward and
    backward timed once by CUDA events (the first calls at this shape).
    The slow run is counted.  Returns (line, launches, the slow path's
    top-k indices)."""
    from multimodal_sae_tpu_torch.sae import forward

    grads, fvu, ms = {}, {}, {}
    for fast in (True, False):
        p = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
        gc.collect()
        if not fast:
            reset_kernel_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        out = forward(p, x, cfg.sae, fast=fast)
        events[1].record()
        out.fvu.backward()
        events[2].record()
        torch.cuda.synchronize()
        ms["fast" if fast else "slow"] = {"forward": events[0].elapsed_time(events[1]),
                                          "backward": events[1].elapsed_time(events[2])}
        if not fast:
            launches = kernel_counts()
            idx = out.latent_indices
        fvu[fast] = out.fvu.item()
        grads[fast] = {n: t.grad for n, t in p.items()}
        del p, out
    expected = {"block_max": 2, "flash_attention": 0, "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
                "flash_attention_bwd_dq": 0, "gather_rows": 1, "splice_decode": 0, "decode_dvals": 1}
    if launches != expected:
        raise AssertionError(f"forward(fast=False) kernel launches {launches}, expected {expected}")
    rel = {n: _l2_rel(grads[False][n], grads[True][n]) for n in params}
    fvu_rel = abs(fvu[False] - fvu[True]) / fvu[True]
    if not (np.isfinite(fvu[False]) and fvu_rel <= FAST_SLOW_REL and all(r <= FAST_SLOW_REL for r in rel.values())):
        raise AssertionError(f"forward(fast=False) differs from the fast path: fvu {fvu}, gradients {rel}")
    del grads
    torch.cuda.empty_cache()
    return ({"tokens": x.shape[0], "fvu_fast": fvu[True], "fvu_slow": fvu[False], "fvu_rel": fvu_rel,
             "grad_l2_rel": rel, "bound": FAST_SLOW_REL, "ms": ms, "launches": launches}, launches, idx)


def check_decode_dvals(W: torch.Tensor, idx: torch.Tensor) -> dict:
    """K2's dvals mode at (tokens, k) = idx's shape on the decoder W, with a
    seeded g: within an fp32 bound of its plain version, equal bits over two
    calls, timed (median of 5) beside its bound and the plain version."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N, k = idx.shape
    d = W.shape[1]
    g = torch.randn(N, d, generator=torch.Generator(device=W.device).manual_seed(4), device=W.device)
    got = gr.decode_dvals(g, idx, W, torch.float32)
    again = gr.decode_dvals(g, idx, W, torch.float32)
    ref = gr.decode_dvals_plain(g, idx, W, torch.float32)
    torch.cuda.synchronize()
    # Each side sums d fp32 products in its own order: each differs from the
    # exact sum by at most d * 2^-24 * sum_d |g[n, d] * W[r, d]|.
    err_bound = 2 * d * 2.0 ** -24 * g.abs().sum(-1).max().item() * W.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= err_bound):
        raise AssertionError(f"decode_dvals off by {err} (bound {err_bound})")
    if not _bits_equal(got, again):
        raise AssertionError("decode_dvals is not deterministic")
    distinct = torch.unique(idx).numel()
    nbytes = distinct * d * W.element_size() + N * d * 4 + N * k * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fma_ms = N * k * d / FP32_FMAS * 1e3
    repeats = time_repeats(lambda: gr.decode_dvals(g, idx, W, torch.float32))
    line = {"tokens": N, "k": k, "W": [W.shape[0], d], "distinct_rows": distinct, "max_abs_err": err,
            "err_bound": err_bound, "deterministic": True, "kernel_ms": repeats["median"],
            "kernel_ms_repeats": repeats, "plain_ms": time_ms(lambda: gr.decode_dvals_plain(g, idx, W, torch.float32), iters=3),
            "bound_ms": max(bytes_ms, fma_ms), "bound_bytes_ms": bytes_ms, "bound_fma_ms": fma_ms,
            "bound_by": "bytes" if bytes_ms >= fma_ms else "operations", "no_reuse_gb": N * k * d * W.element_size() / 1e9}
    del g, got, again, ref
    torch.cuda.empty_cache()
    return line


def phase_train_path(dev, card: str) -> dict:
    """SAE training at the README's command shape on the LLaMA-3-8B-width
    subject (random bf16 weights, 25 layers, hookpoint layers.24), through
    `SaeTrainer`'s `step`, `save` and `load_state`."""
    from collections import defaultdict

    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.train import MemmapDataset, SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    setup(dev)
    hook, B, S, L, k, acc = "layers.24", 8, 2048, 131072, 256, 4
    n_batches = 10  # 8, then one resumed, then one with AuxK
    seconds = {}
    t0 = time.perf_counter()
    cfg_subject = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg_subject, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # LLaMA-3's ids need more than the reference's uint16 tokens.
        ids = np.random.default_rng(2).integers(0, cfg_subject.vocab_size, size=(n_batches * B, S), dtype=np.uint32)
        ids.tofile(os.path.join(tmp, "tokens.bin"))
        dataset = MemmapDataset(os.path.join(tmp, "tokens.bin"), S, dtype=np.uint32)
        batches = list(_iter_batches(dataset, B))

        def config():
            return TrainConfig(sae=SaeConfig(num_latents=L, k=k), batch_size=B, grad_acc_steps=acc,
                               micro_acc_steps=TRAIN_MICRO, lr_warmup_steps=0, log_to_wandb=False,
                               hookpoints=[hook], save_every=10**9, run_name=os.path.join(tmp, "run"))

        t0 = time.perf_counter()
        trainer = SaeTrainer(config(), dataset, model, device=dev)
        torch.cuda.synchronize()
        seconds["init_trainer"] = time.perf_counter() - t0
        metrics = {hook: defaultdict(float)}
        losses = []

        def step(tr, batch, mark=None):
            tr.step(batch, metrics, mark=mark)
            losses.append({key: val * tr.cfg.grad_acc_steps for key, val in metrics[hook].items()})
            metrics[hook].clear()

        # The projected gradient the optimizer is handed at the first
        # boundary, against the decoder rows.
        ortho = {}
        update = trainer.optimizer.update

        def spy(grads, state):
            W, g = trainer.saes[hook].W_dec.detach(), grads["W_dec"]
            ortho["max_dot"] = torch.einsum("ld,ld->l", g, W).abs().max().item()
            ortho["max_row_norm"] = torch.linalg.vector_norm(g, dim=1).max().item()
            return update(grads, state)

        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        reset_kernel_counts()
        t0 = time.perf_counter()
        for i, batch in enumerate(batches[:8]):
            if i == 2:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            trainer.optimizer.update = spy if i == 3 else update
            if i == 6:
                step(trainer, batch)  # not a boundary: the decoder as `accumulate` stored it
                W = trainer.saes[hook].W_dec.detach()
                unit_err = (torch.linalg.vector_norm(W, dim=1) - 1).abs().max().item()
            elif i == 7:
                marks = StageMarks()
                window = {}
                marks.on_apply = lambda: window.update(fired=trainer._fired_dev[hook].clone())
                step(trainer, batch, mark=marks)
            else:
                step(trainer, batch)
        torch.cuda.synchronize()
        seconds["eight_batches"] = time.perf_counter() - t0
        steady_s = time.perf_counter() - t_steady
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stage_ms = marks.ms()
        trainer.optimizer.update = update
        if not unit_err <= UNIT_NORM_TOL:
            raise AssertionError(f"decoder rows after accumulate off unit norm by {unit_err}")
        if not ortho["max_dot"] <= ORTHO_REL * ortho["max_row_norm"]:
            raise AssertionError(f"projected decoder gradient not orthogonal to the rows: {ortho}")
        counts = trainer.num_tokens_since_fired[hook]
        fired = window["fired"].cpu().numpy()
        if not (np.array_equal(counts == 0, fired) and set(np.unique(counts)) <= {0, acc * B * S, 2 * acc * B * S}
                and torch.equal(trainer._dead_mask_dev[hook].cpu(), torch.from_numpy(counts > trainer.cfg.dead_feature_threshold))):
            raise AssertionError("dead-feature counters disagree with the window's fired mask")

        t0 = time.perf_counter()
        trainer.save()
        seconds["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = SaeTrainer(config(), dataset, model, device=dev)
        resumed.load_state(os.path.join(tmp, "run"))
        torch.cuda.synchronize()
        seconds["init_and_load_state"] = time.perf_counter() - t0
        if not _trainer_state_equal(trainer, resumed, hook):
            raise AssertionError("the resumed trainer's state differs from the saved one")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        step(resumed, batches[8])
        # AuxK: half the latents dead (65,536 against k_aux = 2,048: scale 1).
        resumed.cfg.auxk_alpha = 1 / 32
        resumed.cfg.micro_acc_steps = AUXK_MICRO
        resumed.num_tokens_since_fired[hook][::2] = resumed.cfg.dead_feature_threshold + 1
        resumed._refresh_dead_mask(hook)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(resumed, batches[9])
        torch.cuda.synchronize()
        seconds["auxk_batch"] = time.perf_counter() - t0
        auxk_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = kernel_counts()
        expected = {"block_max": 2 * (9 * TRAIN_MICRO + AUXK_MICRO), "flash_attention": 25 * n_batches,
                    "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0,
                    "gather_rows": 0, "splice_decode": 0, "decode_dvals": 0}
        if launches != expected:
            raise AssertionError(f"training kernel launches {launches}, expected {expected}")
        if not all(np.isfinite(v) for line in losses for v in line.values()):
            raise AssertionError(f"non-finite training loss: {losses}")
        if not losses[-1]["auxk"] > 0:
            raise AssertionError(f"AuxK loss {losses[-1]['auxk']} with half the latents dead")

        # Cross-checks on one captured batch.
        with torch.no_grad():
            h = model.capture(batches[0], [hook])[hook].reshape(-1, cfg_subject.hidden_size)
        t0 = time.perf_counter()
        cpu_line = check_accumulate_cpu(h[:1024], dev)
        seconds["cpu_cross_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slow_line, slow_launches, idx = check_fast_vs_slow(resumed.saes[hook].params, h[:4096], resumed.cfg)
        seconds["fast_vs_slow"] = time.perf_counter() - t0
        dvals = check_decode_dvals(resumed.saes[hook].W_dec.detach(), idx)
        del resumed, h, idx
    torch.cuda.empty_cache()

    tokens_steady = 6 * B * S
    emit({
        "phase": "train_path", "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook, "batch_size": B, "ctx_len": S,
        "grad_acc_steps": acc, "micro_acc_steps": TRAIN_MICRO, "auxk_micro_acc_steps": AUXK_MICRO,
        "tokens_per_s": tokens_steady / steady_s, "tokens_per_s_over": "batches 3-8", "seconds": seconds,
        "stage_ms_batch8": stage_ms, "peak_gb": peak_gb, "auxk_peak_gb": auxk_peak_gb,
        "losses": losses, "decoder_unit_norm_err": unit_err, "unit_norm_tol": UNIT_NORM_TOL,
        "projected_grad": ortho, "ortho_rel": ORTHO_REL, "launches": launches,
        "cpu_cross_check": cpu_line, "fast_vs_slow": slow_line, "decode_dvals": dvals, "card": card,
    })
    return {"launches": {name: launches[name] + slow_launches[name] for name in launches}, "dvals": dvals}


UNIFORM_HW = (480, 640)
MIXED_HW = ((480, 640), (336, 336), (300, 900), (1000, 1000))
MIXED_LENGTHS = (2341, 1177, 2329, 2929)
# The image cache's batches (as bench.py's image headline): 4 images of
# 480 x 640 (5 crops, 2,341 tokens a row with the BOS), and 4 geometries
# whose rows the subject right-pads to 2,929.
IMAGE_BOS = 128000
# Each image of the mixed batch run alone (a batch of 1, no mask, its own
# ragged length) must give its row of the mixed batch (right-padded to
# 2,929) bit for bit over its valid tokens at model.layers.24, as every
# chip run has.  Causality keeps right-pad keys away from every valid
# query, so this check cannot see a pad key read: it holds the tower, the
# scatter and K3 consistent across sequence lengths and ragged last tiles.
# K3's key mask is held by phase_flash_attention's right-pad cases.


def _image_batch(cfg, sizes, rng) -> dict:
    """A prepared LLaVA-NeXT batch as `prepare_inputs` builds it (the card's
    machine has no PIL): the prompt [BOS, <image>] with the placeholder
    expanded to each image's token count, right-padded with a mask, and a
    pixel array of each image's crops drawn from `rng`, one array per
    image so that the tower runs once per image."""
    from multimodal_sae_tpu_torch.models.llava_next import get_number_of_features, image_size_to_num_patches

    S = cfg.vision_config.image_size
    pixels, rows = [], []
    for h, w in sizes:
        n_crops = image_size_to_num_patches((h, w), cfg.image_grid_pinpoints, S)
        pixels.append(rng.standard_normal((n_crops, 3, S, S), dtype=np.float32))
        rows.append([IMAGE_BOS] + [cfg.image_token_index] * get_number_of_features(h, w, cfg))
    ids = np.zeros((len(rows), max(map(len, rows))), np.int64)
    mask = np.zeros_like(ids)
    for i, row in enumerate(rows):
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask, "pixel_values": pixels, "image_sizes": list(sizes)}


def check_cached_topk(locs, acts, h, row0: int, sae) -> None:
    """The cached rows row0 .. row0 + B of one batch against an independent
    top-k of its hidden `h` (B, S, D; BOS dropped): each entry's activation
    equals the recomputed latent bit for bit and is at least its token's
    k-th value, no (token, feature) pair repeats, and each token holds as
    many entries as its top-k has values above 1e-5, so the cached set is
    the top-k up to ties at the k-th value."""
    from multimodal_sae_tpu_torch.sae import pre_acts

    B, S1 = h.shape[0], h.shape[1] - 1
    latents = pre_acts(sae.params, h[:, 1:].reshape(-1, h.shape[-1]))
    top = torch.topk(latents, sae.cfg.k, dim=-1).values
    sel = (locs[:, 0] >= row0) & (locs[:, 0] < row0 + B)
    loc = torch.from_numpy(locs[sel]).to(h.device)
    act = torch.from_numpy(acts[sel]).to(h.device)
    tok = (loc[:, 0] - row0) * S1 + loc[:, 1]
    if not torch.equal(latents[tok, loc[:, 2]], act):
        raise AssertionError("a cached activation differs from its recomputed latent")
    if bool((act < top[tok, -1]).any()):
        raise AssertionError("a cached entry lies below its token's k-th value")
    if torch.unique(tok * sae.W_enc.shape[1] + loc[:, 2]).numel() != len(tok):
        raise AssertionError("a (token, feature) pair is cached twice")
    if not torch.equal(torch.bincount(tok, minlength=B * S1), (top > 1e-5).sum(-1)):
        raise AssertionError("a token's cached entries differ in number from its top-k above 1e-5")


def phase_image_cache_path(dev, card: str) -> dict:
    """The image cache at llama3-llava-next-8b's widths (random bf16 weights:
    the CLIP-L/336 tower, the projector and LLaMA-3-8B's text widths cut to
    the 25 layers model.layers.24 reads, flash attention) and the released
    SAE's width (131,072 latents, k=256, fp32), through `FeatureImageCache`
    as the cache_image CLI drives it, on prepared batches."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features import FeatureImageCache
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextConfig, LlavaNextModel
    from multimodal_sae_tpu_torch.ops import sort_pairs_by_index, top_k
    from multimodal_sae_tpu_torch.sae import Sae, pre_acts

    setup(dev)
    hook, n_uniform, batch_size, n_splits = "model.layers.24", 4, 4, 128
    seconds = {}
    t0 = time.perf_counter()
    # The placeholder id 128,256 must index the embedding table.
    cfg = LlavaNextConfig(text_config=LlamaConfig(vocab_size=128257, num_hidden_layers=25, flash_attention=True))
    model = LlavaNextModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    batches = [_image_batch(cfg, [UNIFORM_HW] * batch_size, rng) for _ in range(n_uniform)]
    batches.append(_image_batch(cfg, MIXED_HW, rng))
    lengths = [tuple(int(n) for n in b["attention_mask"].sum(1)) for b in batches]
    if lengths != [(MIXED_LENGTHS[0],) * batch_size] * n_uniform + [MIXED_LENGTHS]:
        raise AssertionError(f"placeholder expansion gave row lengths {lengths}")
    n_images = sum(len(b["image_sizes"]) for b in batches)
    n_tokens = sum(sum(row) for row in lengths)
    positions = sum(b["input_ids"].size for b in batches)

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
        h = model.capture(batches[0], [hook])[hook]
        top_k(pre_acts(sae.params, h[:, 1:].reshape(-1, h.shape[-1])), sae.cfg.k, assume_finite=True)
        torch.cuda.synchronize()
        seconds["warmup"] = time.perf_counter() - t0
        del h

        # The counted run keeps nothing and counts nothing on the host: the
        # checks below capture each batch again.
        save_dir = os.path.join(tmp, "cache")
        fc = FeatureImageCache(lambda batch: model.capture(batch, [hook]), saes, batch_size=batch_size)
        fc.enable_streaming(save_dir, n_splits=n_splits)
        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        reset_kernel_counts()
        t0 = time.perf_counter()
        fc.run(positions, iter(batches), progress=False)
        torch.cuda.synchronize()
        seconds["run"] = time.perf_counter() - t0
        launches = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expected = {"block_max": 2 * len(batches), "flash_attention": 25 * len(batches),
                    "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
                    "flash_attention_bwd_dq": 0, "gather_rows": 0, "splice_decode": 0, "decode_dvals": 0}
        if launches != expected:
            raise AssertionError(f"kernel launches {launches} over {len(batches)} batches, expected {expected}")
        t0 = time.perf_counter()
        fc.save_splits(n_splits, save_dir)
        fc.concate_safetensors(n_splits, save_dir)
        seconds["save_and_merge"] = time.perf_counter() - t0

        locs, acts = check_splits(os.path.join(save_dir, hook), n_splits, 131072)
        n_entries = len(acts)
        rows = sum(len(b["image_sizes"]) for b in batches)
        if not ((locs[:, 0] < rows).all() and set(np.unique(locs[:, 0])) == set(range(rows))):
            raise AssertionError("merged rows out of range")
        # Every batch captured again (the forward is deterministic: the cached
        # activations must equal its latents bit for bit); the per-token
        # counts over every row also hold the splits' total.
        t0 = time.perf_counter()
        row0 = 0
        for batch in batches:
            h = model.capture(batch, [hook])[hook]
            check_cached_topk(locs, acts, h, row0, sae)
            row0 += h.shape[0]
        seconds["check_topk"] = time.perf_counter() - t0
        h_mixed = h
        del locs, acts

    # Each image of the mixed batch alone, a batch of 1 without a mask.
    mixed = batches[-1]
    alone = []
    for i, (hw, n) in enumerate(zip(MIXED_HW, MIXED_LENGTHS)):
        single = {"input_ids": mixed["input_ids"][i : i + 1, :n], "attention_mask": mixed["attention_mask"][i : i + 1, :n],
                  "pixel_values": [mixed["pixel_values"][i]], "image_sizes": [hw]}
        h1 = model.capture(single, [hook])[hook][0]
        ref = h_mixed[i, :n]
        err = (h1.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)
        line = {"size": list(hw), "tokens": n, "equal_bits": _bits_equal(h1, ref),
                "max_row_l2_rel": err.max().item(), "max_abs_err": (h1.float() - ref.float()).abs().max().item()}
        if not line["equal_bits"]:
            raise AssertionError(f"image {hw} alone differs from its row of the mixed batch: {line}")
        alone.append(line)
    del h_mixed

    # Batch 0 again, stage by stage (CUDA events).
    marks = StageMarks()
    embed, pack = model._embed_multimodal, model._project_pack_group

    def timed_pack(*args):
        marks("pixels_to_device")
        out = pack(*args)
        marks("tower_projector_pack")
        return out

    def timed_embed(batch):
        out = embed(batch)
        marks("placeholder_scatter")
        return out

    model._project_pack_group, model._embed_multimodal = timed_pack, timed_embed
    h = model.capture(batches[0], [hook])[hook]
    marks("subject_forward")
    latents = pre_acts(sae.params, h[:, 1:].contiguous().reshape(-1, h.shape[-1]))
    marks("encode")
    vals, idx = top_k(latents, sae.cfg.k, assume_finite=True)
    sort_pairs_by_index(idx, vals)
    marks("top_k")
    stage_ms = marks.ms()
    del model._project_pack_group, model._embed_multimodal, h, latents, vals, idx

    emit({
        "phase": "image_cache_path",
        "subject": "llama3-llava-next-8b widths: CLIP-L/336 tower, projector, LLaMA-3-8B text cut to 25 "
                   "layers, bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook,
        "batches": [b["image_sizes"] for b in batches], "row_lengths": lengths,
        "images": n_images, "tokens": n_tokens, "positions_cached": positions - len(batches) * batch_size,
        # Five batches, a window of seconds: smoke readings, not the cache's
        # throughput or memory, until a benchmark times a longer run.
        "smoke_images_per_s": n_images / seconds["run"], "smoke_tokens_per_s": n_tokens / seconds["run"],
        "smoke_peak_gb": peak_gb, "seconds": seconds, "stage_ms_batch0": stage_ms, "launches": launches,
        "entries": n_entries, "n_splits": n_splits, "alone_vs_mixed": alone, "card": card,
    })
    del model, saes, sae
    return {"launches": launches}


def _record_key(record) -> tuple:
    """A loader record as comparable bytes: tokens exactly, activations bit
    for bit, the sampled `train`."""
    def ex(examples):
        return tuple((e.tokens.dtype.str, e.tokens.tobytes(), e.activations.dtype.str, e.activations.tobytes())
                     for e in examples or ())

    return record.feature.module_name, record.feature.feature_index, ex(record.examples), ex(record.train)


def _timed_load(dataset, constructor, sampler, num_workers: int) -> tuple:
    """(records, {wall_s, cpu_s, constructor_s, sampler_s}) of one collated
    load; the constructor's and sampler's own seconds are summed only on a
    sequential load (None on a threaded one)."""
    spent = {"constructor_s": 0.0, "sampler_s": 0.0}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0

        return call

    if num_workers <= 1:
        constructor, sampler = timed("constructor_s", constructor), timed("sampler_s", sampler)
    else:
        spent = {"constructor_s": None, "sampler_s": None}
    t0, c0 = time.perf_counter(), time.process_time()
    records = dataset.load(collate=True, constructor=constructor, sampler=sampler, num_workers=num_workers)
    return records, {"wall_s": time.perf_counter() - t0, "cpu_s": time.process_time() - c0, **spent}


def check_records(records, module_dir: str, edges: np.ndarray, tokens: np.ndarray, cfg, n_train: int) -> int:
    """Every record against a numpy reconstruction from the raw split, read
    whole (`load_file`, no mmap, no sidecar): the feature's entries by a
    boolean mask in file order, scattered into the dense (rows, seq) batch,
    cut into windows, ranked by their max with ties in window order, the
    top `max_examples` nonzero ones.  Returns the entries checked."""
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    by_split: dict = {}
    for r in records:
        by_split.setdefault(int(np.searchsorted(edges, r.feature.feature_index, side="right")) - 1, []).append(r)
    rows, seq = tokens.shape
    tok_windows = tokens[:, : seq // cfg.example_ctx_len * cfg.example_ctx_len].reshape(-1, cfg.example_ctx_len)
    checked = 0
    for split, recs in by_split.items():
        data = load_file(os.path.join(module_dir, f"{edges[split]}_{edges[split + 1] - 1}.safetensors"))
        locs, acts = data["locations"].numpy(), data["activations"].numpy()
        for r in recs:
            mask = locs[:, 2] == r.feature.feature_index
            checked += int(mask.sum())
            dense = np.zeros((rows, seq), acts.dtype)
            np.add.at(dense, (locs[mask, 0], locs[mask, 1]), acts[mask])
            windows = dense[:, : tok_windows.size // rows].reshape(-1, cfg.example_ctx_len)
            pools = windows.max(axis=1)
            order = np.lexsort((np.arange(len(pools)), -pools))[: min(cfg.max_examples, int((pools != 0).sum()))]
            want = tuple((tok_windows.dtype.str, tok_windows[i].tobytes(), windows.dtype.str, windows[i].tobytes())
                         for i in order)
            got = _record_key(r)
            if got[2] != want:
                raise AssertionError(f"record {r.feature} differs from its reconstruction from the raw split")
            if got[3] != want[:n_train]:
                raise AssertionError(f"record {r.feature}'s train is not its top {n_train} examples")
    return checked


def phase_loader_path(card: str, cache_dir: str, hook: str, tokens: np.ndarray) -> dict:
    """Feature loading (`FeatureDataset`) over the 128 splits the cache path
    merged, through the entry points a user calls: a filtered
    build of 2,000 features drawn with a seed from those the cache holds
    (`pool_max_activation_windows` on the cache's token rows, `sample`),
    sequential and threaded; then 8 splits unfiltered, first on the scan
    path (their sidecars removed; the load heals them), then through the
    sidecars.  Host numpy only: no kernel of the port runs."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import ExperimentConfig, FeatureConfig
    from multimodal_sae_tpu_torch.features import FeatureDataset, loader, pool_max_activation_windows, sample
    from multimodal_sae_tpu_torch.features.split_index import index_path, mmap_safetensors

    width, n_splits, n_filter, n_unfiltered = 131072, 128, 2000, 8
    module_dir = os.path.join(cache_dir, hook)
    fcfg = FeatureConfig(width=width, n_splits=n_splits, example_ctx_len=64)
    ecfg = ExperimentConfig()
    edges = np.linspace(0, width, n_splits + 1).astype(np.int64)
    counts = np.zeros(width, np.int64)
    for start, end in zip(edges[:-1], edges[1:]):
        feats = mmap_safetensors(os.path.join(module_dir, f"{start}_{end - 1}.safetensors"))["locations"][:, 2]
        counts += np.bincount(feats, minlength=width)
    held = np.flatnonzero(counts)
    selected = np.sort(np.random.default_rng(7).choice(held, size=n_filter, replace=False))
    kept = selected[counts[selected] >= fcfg.min_examples]
    if not 0 < len(kept) < n_filter:
        raise AssertionError(f"{len(kept)} of the {n_filter} drawn features reach min_examples; "
                             "the draw must keep some and skip some")
    load_kw = dict(constructor=partial(pool_max_activation_windows, tokens=tokens, cfg=fcfg),
                   sampler=partial(sample, cfg=ecfg))
    hits = {"sidecar": 0, "scan": 0}
    hits_lock = threading.Lock()
    read_index = loader.read_index

    def counted_read_index(*args, **kw):
        out = read_index(*args, **kw)
        with hits_lock:
            hits["scan" if out is None else "sidecar"] += 1
        return out

    loader.read_index = counted_read_index
    builds = {}
    gc.collect()
    reset_kernel_counts()
    try:
        ds = FeatureDataset(cache_dir, fcfg, modules=[hook], features={hook: selected})
        filtered, times = _timed_load(ds, num_workers=1, **load_kw)
        builds["filtered_sequential"] = dict(buffers=len(ds), entries=int(counts[selected].sum()),
                                             records=len(filtered), **times)
        ds = FeatureDataset(cache_dir, fcfg, modules=[hook], features={hook: selected})
        threaded, times = _timed_load(ds, num_workers=LOADER_WORKERS, **load_kw)
        builds[f"filtered_{LOADER_WORKERS}_workers"] = dict(buffers=len(ds), entries=int(counts[selected].sum()),
                                                            records=len(threaded), **times)
        filtered_hits = dict(hits)
        # Unfiltered: the first 8 splits, their merge-time sidecars removed.
        for start, end in zip(edges[:n_unfiltered], edges[1 : n_unfiltered + 1]):
            os.remove(index_path(os.path.join(module_dir, f"{start}_{end - 1}.safetensors")))
        unfiltered = {}
        for path in ("scan", "sidecar"):
            ds = FeatureDataset(cache_dir, fcfg, modules=[hook])
            ds.buffers = ds.buffers[:n_unfiltered]
            before = dict(hits)
            unfiltered[path], times = _timed_load(ds, num_workers=1, **load_kw)
            if hits[path] - before[path] != n_unfiltered:
                raise AssertionError(f"the unfiltered {path} build read {hits} (before: {before})")
            builds[f"unfiltered_{path}"] = dict(buffers=n_unfiltered, entries=int(counts[: edges[n_unfiltered]].sum()),
                                                records=len(unfiltered[path]), **times)
    finally:
        loader.read_index = read_index
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"the loader launched kernels: {launches}")
    n_buffers = builds["filtered_sequential"]["buffers"]
    if filtered_hits != {"sidecar": 2 * n_buffers, "scan": 0}:
        raise AssertionError(f"the filtered builds did not read through the merge's sidecars: {filtered_hits}")
    keys = [_record_key(r) for r in filtered]
    if [r.feature.feature_index for r in filtered] != kept.tolist():
        raise AssertionError("the filtered build's records are not the drawn features that reach min_examples")
    if [_record_key(r) for r in threaded] != keys:
        raise AssertionError("the threaded load differs from the sequential one")
    if [_record_key(r) for r in unfiltered["sidecar"]] != [_record_key(r) for r in unfiltered["scan"]]:
        raise AssertionError("the sidecar path's records differ from the scan path's")
    t0 = time.perf_counter()
    checked = check_records(filtered, module_dir, edges, tokens, fcfg, ecfg.n_examples_train)
    checked += check_records(unfiltered["scan"], module_dir, edges, tokens, fcfg, ecfg.n_examples_train)
    check_s = time.perf_counter() - t0
    for b in builds.values():
        b.update(records_per_s=b["records"] / b["wall_s"], entries_per_s=b["entries"] / b["wall_s"],
                 host_cpu_share=b["cpu_s"] / b["wall_s"])
    emit({
        "phase": "loader_path", "note": "smoke readings of one short run, not throughput",
        "cache": f"{hook}, {n_splits} splits, {int(counts.sum())} entries, {len(held)} features held",
        "filter": {"drawn": n_filter, "kept": len(kept), "skipped_under_min_examples": n_filter - len(kept)},
        "min_examples": fcfg.min_examples, "example_ctx_len": fcfg.example_ctx_len, "builds": builds,
        "records_checked_against_raw_splits": len(filtered) + len(unfiltered["scan"]),
        "entries_checked": checked, "check_s": check_s, "threaded_equals_sequential": True,
        "scan_equals_sidecar": True, "launches": launches, "card": card,
    })
    # The stats phase needs only each record's feature: drop the examples
    # (about a million Python objects and their arrays) once checked.
    for r in filtered:
        r.examples = r.train = None
    return {"launches": launches, "records": filtered, "selected": selected}


class _StubTokenizer:
    """Token ids as strings (the card's machine has no tokenizer library)."""

    def batch_decode(self, ids):
        return [str(int(np.asarray(i).ravel()[0])) for i in ids]


def _near_tie_order(got_idx, ref: torch.Tensor, what: str) -> None:
    """`got_idx` (rows, k) against the float64 values `ref` (rows, n): at
    each rank the chosen candidate's value must be within STATS_NEAR_TIE of
    the float64 order's value at that rank."""
    got_idx = torch.as_tensor(np.asarray(got_idx), device=ref.device)
    want = torch.sort(ref, dim=-1, descending=True, stable=True).values[:, : got_idx.shape[1]]
    gap = (torch.gather(ref, 1, got_idx) - want).abs().max().item()
    if not gap <= STATS_NEAR_TIE:
        raise AssertionError(f"{what}: an index differs from the float64 order by {gap} (> {STATS_NEAR_TIE})")


def phase_stats_path(dev, card: str, model, sae, records, selected) -> dict:
    """Feature statistics and PCA on the card, on the attribution phase's
    SAE decoder (131,072 x 4,096 fp32) and subject's LM head (128,256 x
    4,096 bf16): `get_neighbors` for the loader's 2,000 drawn features at
    k = 10, `logits` for the loader's records, `PcaReducer.fit_sae_list` at
    the full decoder (the thin SVD timed beside it); each held against
    float64 on the card."""
    from multimodal_sae_tpu_torch.features import stats
    from multimodal_sae_tpu_torch.features.dim_reduce import PcaReducer

    hook = "layers.24"
    W_dec, W_U = sae.params["W_dec"], model.params["lm_head"]
    out, base_gb = {}, torch.cuda.memory_allocated() / 1e9

    def timed(name, fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak_gb_above_resident": torch.cuda.max_memory_allocated() / 1e9 - base_gb}
        return result

    reset_kernel_counts()
    timed("get_neighbors_warmup", lambda: stats.get_neighbors({hook: sae}, {hook: selected[:16]}, k=10, device=dev))
    neighbors, _ = timed("get_neighbors", lambda: stats.get_neighbors({hook: sae}, {hook: selected}, k=10, device=dev))
    top = timed("logits", lambda: stats.logits(records, W_U, W_dec.T, k=10, tokenizer=_StubTokenizer(), device=dev))
    pca = timed("pca_fit_sae_list", lambda: PcaReducer(n_components=2, device=dev).fit_sae_list([sae]))
    # The JAX package's route, the thin SVD of the centred decoder, timed
    # beside the port's Gram route as the reason for taking the latter.
    svd = timed("pca_svd_reference", lambda: torch.linalg.svd(W_dec - W_dec.mean(dim=0), full_matrices=False).Vh[:2])
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"the stats phase launched kernels: {launches}")
    out["get_neighbors"].update(features=len(selected), k=10, cos_gb=len(selected) * W_dec.shape[0] * 4 / 1e9)
    out["logits"].update(records=len(records), k=10)
    out["pca_fit_sae_list"].update(rows=W_dec.shape[0], cols=W_dec.shape[1])

    # float64 on the card for 16 features.
    t0 = time.perf_counter()
    sel = torch.as_tensor(selected[:16], device=dev)
    W64 = W_dec.double()
    unit = W64 / (torch.linalg.vector_norm(W64, dim=1, keepdim=True) + 1e-12)
    cos64 = unit[sel] @ unit.T  # (16, L)
    got_idx = np.array([[int(f)] + neighbors[hook][i]["indices"] for i, f in enumerate(selected[:16])])
    _near_tie_order(got_idx, cos64, "get_neighbors")
    got_vals = torch.tensor([neighbors[hook][i]["values"] for i in range(16)], dtype=torch.float64, device=dev)
    cos_err = (got_vals - torch.gather(cos64, 1, torch.as_tensor(got_idx[:, 1:], device=dev))).abs().max().item()
    if not cos_err <= STATS_ATOL:
        raise AssertionError(f"neighbour cosines differ from float64 by {cos_err}")
    del unit, cos64
    feats16 = torch.tensor([r.feature.feature_index for r in records[:16]], device=dev)
    logits64 = W_U.double() @ W64[feats16].T  # (V, 16)
    _near_tie_order(np.array([[int(t) for t in r.top_logits] for r in records[:16]]), logits64.T.contiguous(), "logits")
    del logits64
    c = pca.components_.double()
    eye = torch.eye(2, device=dev, dtype=torch.float64)
    ortho = (c @ c.T - eye).abs().max().item()
    svd_ortho = (svd.double() @ svd.double().T - eye).abs().max().item()
    del svd
    Xc = W64 - W64.mean(dim=0)
    del W64
    cov = Xc.T @ Xc / (Xc.shape[0] - 1)
    del Xc
    eig = torch.linalg.eigvalsh(cov)[-2:].flip(0)
    ev = ((c @ cov) * c).sum(dim=1)
    ev_rel = ((ev - eig).abs() / eig).max().item()
    del cov
    if not ortho <= PCA_ORTHO:
        raise AssertionError(f"PCA components are orthonormal only within {ortho}")
    if not ev_rel <= PCA_EV_REL:
        raise AssertionError(f"PCA explained variance {ev.tolist()} against eigenvalues {eig.tolist()}: rel {ev_rel}")
    emit({
        "phase": "stats_path", "decoder": "131072 x 4096 fp32", "lm_head": "128256 x 4096 bf16",
        "calls": out, "float64_check_s": time.perf_counter() - t0, "checked_features": 16,
        "neighbor_cos_max_abs_err": cos_err, "pca_ortho_err": ortho, "svd_reference_ortho_err": svd_ortho,
        "pca_explained_variance": ev.tolist(),
        "cov_top_eigenvalues": eig.tolist(), "pca_ev_rel_err": ev_rel, "launches": launches, "card": card,
    })
    return {"launches": launches}


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
    # The loader reads the splits the cache phase merged, in its directory.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        cache = phase_cache_path(dev, card, work_dir)
        loaded = phase_loader_path(card, cache.pop("cache_dir"), cache.pop("hook"), cache.pop("tokens"))
    torch.cuda.empty_cache()
    attribution = phase_attribution_path(dev, card)
    stats = phase_stats_path(dev, card, attribution.pop("model"), attribution.pop("sae"),
                             loaded["records"], loaded["selected"])
    loader_launches = loaded["launches"]
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train_path(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    image = phase_image_cache_path(dev, card)
    runs = (cache["launches"], loader_launches, attribution["launches"], stats["launches"],
            train["launches"], image["launches"])
    total = {name: sum(run[name] for run in runs) for name in runs[0]}
    k2, splice, dvals = attribution["k2"], attribution["splice"], train["dvals"]
    bwd_launches = {part: total[f"flash_attention_bwd_{part}"] for part in ("delta", "dkdv", "dq")}
    kernels_line = {"kernels": [
        {"name": "block_max", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/block_max.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_topk.py:48",
         "launches": total["block_max"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": k1["library_ms"], "image_step": k1["image_step"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/flash_attention.cu",
         "replaces": "multimodal_sae_tpu/models/llama.py:341",
         "launches": total["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"], "image_shapes": k3["image_shapes"],
         "right_pad_edges_max_abs_err": k3["right_pad_edges_max_abs_err"]},
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
        {"name": "decode_dvals", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/gather_rows.cu",
         "replaces": "multimodal_sae_tpu/ops/sparse_decode.py:132",
         "launches": total["decode_dvals"], "max_abs_err": dvals["max_abs_err"],
         "ms": dvals["kernel_ms"], "plain_ms": dvals["plain_ms"], "bound_ms": dvals["bound_ms"],
         "bound_by": dvals["bound_by"], "library_ms": None},
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
