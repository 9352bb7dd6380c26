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
   shape, unmasked and with one row left-padded by 100, then at edge shapes;
4. cache_path: a random LLaMA-3-8B-width subject (25 layers for hookpoint
   layers.24, bf16, flash attention) feeding a 131,072-latent k=256 fp32 SAE
   (saved with `save_to_disk`, read back through `load_saes`) through
   `FeatureCache` with streaming splits over 4 batches of 8 x 2,048 tokens,
   then `save_splits` and `concate_safetensors`; checks the launch counts,
   the merged entries, the feature ranges and one batch's top-k;
5. a `kernels` JSON line, the card line, and the result line.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""

from __future__ import annotations

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
K3_ATOL = 2e-2
K3_RTOL = 2e-2
# K3 tolerance, |kernel - plain| <= atol + rtol * |plain|: both outputs are
# bf16 (one ulp is 2^-8 relative) and the kernel rounds the softmax weights
# to bf16 before the PV product (2^-9 relative each); the plain version keeps
# them in fp32.  The outputs are averages of N(0, 1) values, |o| < ~4.


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


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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
        line = {
            "phase": "flash_attention", "shape": [B, H, kvH, S, hd], "padded": padded,
            "max_abs_err": err, "atol": K3_ATOL, "rtol": K3_RTOL,
            "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v, pad_mask, scale)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, pad_mask, scale), iters=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=sdpa_mask, is_causal=sdpa_mask is None, scale=scale)),
            "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
        }
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
    from multimodal_sae_tpu_torch.ops import block_max as bm
    from multimodal_sae_tpu_torch.ops import flash_attention as fa
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
        bm.launches = 0
        fa.launches = 0
        t0 = time.perf_counter()
        fc.run(ctx_len, rows, progress=False)
        torch.cuda.synchronize()
        seconds["run"] = time.perf_counter() - t0
        launches = {"block_max": bm.launches, "flash_attention": fa.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if launches != {"block_max": 2 * n_batches, "flash_attention": 25 * n_batches}:
            raise AssertionError(f"kernel launches {launches} over {n_batches} batches")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_build()
    k1 = phase_block_max(dev)
    k3 = phase_flash_attention(dev)
    cache = phase_cache_path(dev, card)
    kernels_line = {"kernels": [
        {"name": "block_max", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/block_max.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_topk.py:48",
         "launches": cache["launches"]["block_max"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": k1["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/flash_attention.cu",
         "replaces": "multimodal_sae_tpu/models/llama.py:341",
         "launches": cache["launches"]["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]},
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
