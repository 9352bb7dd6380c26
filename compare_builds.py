#!/usr/bin/env python3
"""Time builds of one of the port's CUDA kernels against one another on one
card, in one process, in turns.

    python3 compare_builds.py flash_fwd [--source NAME=PATH.cu ...] [--unchecked NAME=PATH.cu ...] [--out DIR]
    python3 compare_builds.py splice [--source NAME=PATH.cu ...] [--unchecked NAME=PATH.cu ...] [--out DIR]

Each `--source` is another build of the kernel's source with the package's
C entry point (an older revision, say `git show
REV:multimodal_sae_tpu_torch/csrc/flash_attention.cu > old.cu`, or a variant
under a git-ignored directory), compiled with nvcc for sm_90a beside the
package's own headers into `DIR/compare_KERNEL/` (`--out`, default
`compare_out`) and loaded with ctypes.  The package's own kernel is always
timed, as `package`, beside a yardstick.  Every `--source` build is first
held against the kernel's reference and timed only where it passes; an
`--unchecked` build (a diagnostic cut of the kernel, which cannot be right)
is timed without the check.  Then each of REPEATS repeats times every build
(chip_smoke.time_ms: CUDA events, mean of 10 launches after 2) in one order
and the next repeat in the reverse order.  Prints one JSON line a shape
(median, min and max of the repeats) and the card's name and power limit,
and writes the same to `DIR/compare_KERNEL.json`.  Needs one card.

flash_fwd -- the K3 forward (`flash_attention.cu`, C entry
`flash_attention_fwd_bf16`), with SDPA as the yardstick.  The check: the
plain version at (2, 32, 8, 2,048, 128), output and lse, padded and not,
with chip_smoke.py's tolerances.  The shapes: the main path's (8, 32, 8,
2,048, 128), the same with row 0 left-padded by 100, and (8, 32, 8, 2,432,
128) with lse; each line adds TFLOP/s at the median.

splice -- K2's splice mode (`gather_rows.cu`, C entry `splice_decode`),
with the parent path's decode (K2's decode mode over `reselect`'s (F·N, k)
lists, `parent_decode`) as the yardstick.  The pools are chip_smoke.py's:
the attribution prefix of a random LLaMA-3-8B-width subject (seed 0; the
prefix runs the 25 layers that `layers.24` reads) with the 131,072-latent
k = 256 fp32 SAE (seed 0, decoder), over one prompt of 2,432 random ids
(numpy seed 1); the chunks are the last position's 8 largest features
(`inside`), 8 features in no token's pool (`outside`) and 32 features of
token 255 on the first 256 tokens (`F32`).  A fourth chunk, `all_hit`,
takes a synthetic pool over the same decoder: 2,432 tokens' top 257 of
uniform random latents with features 0-7 raised by 0.9995, so that all 8
sit in nearly every token's top-k.  The check, on each chunk: equal bits to
the parent path, `(gather_decode(reselect) + b_dec).to(clean.dtype)`.  Each
line adds the hit count and the two bound terms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from multimodal_sae_tpu_torch import kernels

REPEATS = 5


def build(kernel: str, name: str, src: Path, out: Path, notes: tuple) -> ctypes.CDLL:
    """nvcc of `src` with the package's flags and headers; prints ptxas's
    lines that mention one of `notes`."""
    out_dir = out / f"compare_{kernel}"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(lib), str(src)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "error" in line or any(note in line for note in notes):
            print(f"ptxas[{name}]: {line.strip()}", flush=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}")
    return ctypes.CDLL(str(lib))


def time_in_turns(calls: dict) -> dict:
    """Each of REPEATS repeats times every call, in one order and then the
    reverse; median, min, max and all repeats a call."""
    names = list(calls)
    times = {name: [] for name in names}
    for r in range(REPEATS):
        for name in names if r % 2 == 0 else reversed(names):
            times[name].append(cs.time_ms(calls[name]))
    return {name: {"median": statistics.median(ts), "min": min(ts), "max": max(ts), "all": ts}
            for name, ts in times.items()}


# --- flash_fwd ---------------------------------------------------------------


def flash_launcher(lib: ctypes.CDLL):
    """fwd(q, k, v, pad_mask, scale, need_lse) -> (o, lse) through `lib`."""
    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    fn = lib.flash_attention_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]

    def fwd(q, k, v, pad_mask, scale, need_lse=False):
        B, H, S, hd = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) if need_lse else None
        kv_valid = fa._kv_valid(q, pad_mask)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), fa._ptr(kv_valid), o.data_ptr(), fa._ptr(lse),
                 B, H, k.shape[1], S, hd, fa._scale_q(q, scale), torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "flash_attention_fwd_bf16")
        return o, lse

    return fwd


def _qkv(gen, B, H, kvH, S, hd, dev):
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v


def _flash_check(name, fwd, gen, dev) -> dict:
    """The build against the plain version, padded and not, output and lse."""
    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(gen, 2, 32, 8, 2048, 128, dev)
    out = {}
    for pad in (0, 100):
        pad_mask = None
        if pad:
            pad_mask = torch.ones(2, 2048, dtype=torch.int32, device=dev)
            pad_mask[0, :pad] = 0
        o, lse = fwd(q, k, v, pad_mask, 128 ** -0.5, need_lse=True)
        ro, rl = fa.flash_attention_fwd_plain(q, k, v, pad_mask, 128 ** -0.5)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs()
        if not bool((err <= cs.K3_ATOL + cs.K3_RTOL * ro.float().abs()).all()):
            raise AssertionError(f"{name} off by {err.max().item()} (left pad {pad})")
        out[f"pad{pad}"] = {"max_abs_err": err.max().item(), "lse_max_abs_err": cs._check_lse(lse, rl, name)}
    return out


def run_flash_fwd(builds: dict, unchecked: dict, dev, report: dict) -> None:
    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(7)
    report["resources"] = {hd: fa.fwd_resources(hd) for hd in (128, 64)}
    for name, fwd in list(builds.items()):
        try:
            report["checks"][name] = _flash_check(name, fwd, gen, dev)
        except (AssertionError, RuntimeError) as e:  # a wrong build is reported and not timed
            report["checks"][name] = {"failed": str(e)}
            if name == "package":
                raise
            del builds[name]
    builds.update(unchecked)
    torch.cuda.empty_cache()
    cs.emit({"checks": report["checks"], "resources": report["resources"]})

    H, kvH, hd = 32, 8, 128
    scale = hd ** -0.5
    for S, pad, need_lse in ((2048, 0, False), (2048, 100, False), (2432, 0, True)):
        B = 8
        q, k, v = _qkv(gen, B, H, kvH, S, hd, dev)
        real = torch.ones(B, S, dtype=torch.bool, device=dev)
        real[0, :pad] = False
        pad_mask = real.to(torch.int32) if pad else None
        sdpa_mask = None
        if pad:
            sdpa_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril() & real[:, None, None, :]
            sdpa_mask[0, :, :pad, 0] = True  # SDPA needs a key per row; timing only
        calls = {name: (lambda f=fwd: f(q, k, v, pad_mask, scale, need_lse=need_lse)) for name, fwd in builds.items()}
        calls["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, is_causal=sdpa_mask is None, scale=scale, enable_gqa=True)
        times = time_in_turns(calls)
        pairs = torch.tril(torch.ones(S, S, device=dev))[None] * real[:, None, :].float()
        flops = 4.0 * hd * H * pairs.sum().item()
        nbytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2 + (B * H * S * 4 if need_lse else 0)
        for t in times.values():
            t["tflops"] = flops / t["median"] / 1e9
        line = {"shape": [B, H, kvH, S, hd], "left_pad_row0": pad, "lse": need_lse, "unchecked": sorted(unchecked),
                "bound_ms": max(flops / cs.BF16_FLOPS, nbytes / cs.HBM_BYTES_PER_S) * 1e3, "ms": times}
        cs.emit(line)
        report["shapes"].append(line)
        del q, k, v, calls
        torch.cuda.empty_cache()


# --- splice ------------------------------------------------------------------


def splice_launcher(lib: ctypes.CDLL):
    """splice(wide_idx, wide_vals, drop, k, W, b, clean) through `lib`."""
    fn = lib.splice_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def splice(wide_idx, wide_vals, drop, k, W, b, clean):
        (N, kw), (F, d) = wide_idx.shape, (drop.shape[0], W.shape[1])
        out = torch.empty(F * N, d, dtype=clean.dtype, device=W.device)
        err = fn(W.data_ptr(), wide_idx.data_ptr(), wide_vals.data_ptr(), drop.data_ptr(), b.data_ptr(),
                 clean.data_ptr(), out.data_ptr(), W.shape[0], N, F, d, k, kw,
                 int(W.dtype == torch.bfloat16), int(clean.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "splice_decode")
        return out

    return splice


def _prefix(dev):
    """The attribution prefix's pool and clean splice, as chip_smoke.py's
    attribution phase builds them."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features.patching import build_fast_attribution, get_logit_diff
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae

    setup(dev)
    cfg = LlamaConfig(flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sae = Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=True, seed=0, device=dev)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 2432))
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))
    step = build_fast_attribution(model, "layers.24", sae, {"input_ids": ids}, metric)
    del model
    return step, sae


def _synthetic_pool(W, b, N, k, dev):
    """N tokens' top-(k+1) of uniform random latents with features 0-7
    raised by 0.9995, and their clean splice (bf16)."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    gen = torch.Generator(device=dev).manual_seed(0)
    lat = torch.rand(N, W.shape[0], generator=gen, device=dev)
    lat[:, :8] += 0.9995
    vals, idx = torch.topk(lat, k + 1)
    idx = idx.to(torch.int32)
    clean = (gr.gather_decode(idx[:, :k], vals[:, :k], W) + b).to(torch.bfloat16)
    return idx, vals, clean


def run_splice(builds: dict, unchecked: dict, dev, report: dict) -> None:
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    step, sae = _prefix(dev)
    W, b, k = sae.params["W_dec"], sae.params["b_dec"], step.k
    clean = step.clean.reshape(-1, W.shape[1])
    idx32 = step.wide_idx.to(torch.int32).contiguous()
    in_pool = torch.zeros(W.shape[0], dtype=torch.bool, device=dev)
    in_pool[step.wide_idx.long().reshape(-1)] = True
    N = clean.shape[0]
    pool = (idx32, step.wide_vals, clean)
    chunks = {"inside": (pool, step.wide_idx[-1, :8].long().tolist(), N),
              "outside": (pool, torch.nonzero(~in_pool).reshape(-1)[:8].tolist(), N),
              "F32": (pool, step.wide_idx[255, :32].long().tolist(), 256),
              "all_hit": (_synthetic_pool(W, b, N, k, dev), list(range(8)), N)}
    for chunk, ((p_idx, p_vals, p_clean), feats, n) in chunks.items():
        drop = gr.drop_positions(p_idx[:n], torch.tensor(feats, device=dev))
        args = (p_idx[:n], p_vals[:n], drop, k, W, b, p_clean[:n])
        ref, (vals, idx) = cs._splice_parent(*args)
        for name, fn in list(builds.items()):
            got = fn(*args)
            torch.cuda.synchronize()
            ok = cs._bits_equal(got, ref)
            report["checks"].setdefault(name, {})[chunk] = ok
            if not ok:
                if name == "package":
                    raise AssertionError(f"the package's splice differs from the parent path on {chunk}")
                del builds[name]
        calls = {name: (lambda f=fn: f(*args)) for name, fn in {**builds, **unchecked}.items()}
        calls["parent_decode"] = lambda: gr.gather_decode(idx, vals, W)
        times = time_in_turns(calls)
        hits = drop < k
        hit_tokens = hits.any(0)
        n_hit_tokens = int(hit_tokens.sum())
        distinct = torch.unique(args[0][hit_tokens]).numel() if n_hit_tokens else 0
        F, d = drop.shape[0], W.shape[1]
        # chip_smoke.py's bound: the pool is read only for tokens with a hit.
        nbytes = F * n * d * 2 + n * d * 2 + F * n * 4 + n_hit_tokens * (k + 1) * 8 + d * 4 + distinct * d * 4
        line = {"chunk": chunk, "features": F, "tokens": n, "hit_pairs": int(hits.sum()),
                "hit_tokens": n_hit_tokens, "distinct_rows_of_hit_tokens": distinct,
                "unchecked": sorted(unchecked), "bound_bytes_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                "bound_fma_ms": int(hits.sum()) * k * d / cs.FP32_FMAS * 1e3, "ms": times}
        cs.emit(line)
        report["shapes"].append(line)
        del ref, vals, idx, calls
        torch.cuda.empty_cache()
    cs.emit({"checks": report["checks"]})


KERNELS = {  # name: (the package's library, its entry, a build's launcher, ptxas notes to print, run)
    "flash_fwd": ("flash_attention", "flash_attention_fwd", flash_launcher,
                  ("registers", "spill", "serialized"), run_flash_fwd),
    "splice": ("gather_rows", "splice_decode", splice_launcher, ("registers", "spill", "splice"), run_splice),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--unchecked", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--out", type=Path, default=Path("compare_out"), metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_builds: no CUDA device", file=sys.stderr)
        return 1
    library, entry, launcher, notes, run = KERNELS[args.kernel]
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    for line in kernels.build([library]).get(library, "").splitlines():
        if any(note in line for note in notes):
            print(f"ptxas[package]: {line.strip()}", flush=True)
    module = __import__(f"multimodal_sae_tpu_torch.ops.{library}", fromlist=[entry])
    builds = {"package": getattr(module, entry)}
    for spec in args.source:
        name, path = spec.split("=", 1)
        builds[name] = launcher(build(args.kernel, name, Path(path), args.out, notes))
    unchecked = {}
    for spec in args.unchecked:
        name, path = spec.split("=", 1)
        unchecked[name] = launcher(build(args.kernel, name, Path(path), args.out, notes))
    report = {"card": card, "checks": {}, "shapes": []}
    run(builds, unchecked, dev, report)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"compare_{args.kernel}.json").write_text(json.dumps(report, indent=1))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
