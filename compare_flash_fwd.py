#!/usr/bin/env python3
"""Time builds of the K3 forward (`flash_attention.cu`) against one another on
one CUDA card, in one process, in turns.

    python3 compare_flash_fwd.py [--source NAME=PATH.cu ...] [--unchecked NAME=PATH.cu ...]
                                 [--out DIR]

Each `--source` is another build of a flash-attention forward source with
the package's C entry point `flash_attention_fwd_bf16` (an older revision, say
`git show REV:multimodal_sae_tpu_torch/csrc/flash_attention.cu > old.cu`),
compiled with nvcc for sm_90a beside the package's own headers into
`DIR/compare_flash_fwd/` (`--out`, default `compare_out`) and loaded with
ctypes.  The package's own
kernel (`ops.flash_attention.flash_attention_fwd`) is always timed, as
`package`, and SDPA as the yardstick.  Every `--source` build is first held
against the plain version at (2, 32, 8, 2,048, 128), output and lse, with
chip_smoke.py's tolerances, and timed only if it passes; an `--unchecked`
build (a diagnostic cut of the kernel, say one without its softmax, which
cannot be right) is timed without the check.  Then, at the main path's
shapes -- (8, 32, 8, 2,048, 128), the same with row 0 left-padded by 100,
and (8, 32, 8, 2,432, 128) with lse -- each of REPEATS repeats times every
build (chip_smoke.time_ms: CUDA events, mean of 10 launches after 2) in one
order and the next repeat in the reverse order.
Prints one JSON line a shape (median, min and max of the repeats, and
TFLOP/s at the median) and the card's name and power limit, and writes the
same to `DIR/compare_flash_fwd.json`.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from multimodal_sae_tpu_torch import kernels
from multimodal_sae_tpu_torch.ops import flash_attention as fa

REPEATS = 5


def build(name: str, src: Path, out: Path) -> ctypes.CDLL:
    out_dir = out / "compare_flash_fwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(lib), str(src)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line or "serialized" in line:
            print(f"ptxas[{name}]: {line.strip()}", flush=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}")
    return ctypes.CDLL(str(lib))


def launcher(lib: ctypes.CDLL):
    """fwd(q, k, v, pad_mask, scale, need_lse) -> (o, lse) through `lib`."""
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


def inputs(gen, B, H, kvH, S, hd, dev):
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v


def check(name, fwd, gen, dev) -> dict:
    """The build against the plain version, padded and not, output and lse."""
    q, k, v = inputs(gen, 2, 32, 8, 2048, 128, dev)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--unchecked", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--out", type=Path, default=Path("compare_out"), metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    for line in kernels.build(["flash_attention"]).get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line or "serialized" in line:
            print(f"ptxas[package]: {line.strip()}", flush=True)
    builds = {"package": fa.flash_attention_fwd}
    for spec in args.source:
        name, path = spec.split("=", 1)
        builds[name] = launcher(build(name, Path(path), args.out))
    unchecked = {}
    for spec in args.unchecked:
        name, path = spec.split("=", 1)
        unchecked[name] = launcher(build(name, Path(path), args.out))
    gen = torch.Generator(device=dev).manual_seed(7)
    report = {"card": card, "checks": {}, "resources": {hd: fa.fwd_resources(hd) for hd in (128, 64)},
              "shapes": []}
    for name, fwd in list(builds.items()):
        try:
            report["checks"][name] = check(name, fwd, gen, dev)
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
        q, k, v = inputs(gen, B, H, kvH, S, hd, dev)
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
        names = list(calls)
        times = {name: [] for name in names}
        for r in range(REPEATS):
            for name in names if r % 2 == 0 else reversed(names):
                times[name].append(cs.time_ms(calls[name]))
        pairs = torch.tril(torch.ones(S, S, device=dev))[None] * real[:, None, :].float()
        flops = 4.0 * hd * H * pairs.sum().item()
        nbytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2 + (B * H * S * 4 if need_lse else 0)
        line = {"shape": [B, H, kvH, S, hd], "left_pad_row0": pad, "lse": need_lse, "unchecked": sorted(unchecked),
                "bound_ms": max(flops / cs.BF16_FLOPS, nbytes / cs.HBM_BYTES_PER_S) * 1e3, "ms": {}}
        for name, ts in times.items():
            med = statistics.median(ts)
            line["ms"][name] = {"median": med, "min": min(ts), "max": max(ts), "tflops": flops / med / 1e9,
                                "all": ts}
        cs.emit(line)
        report["shapes"].append(line)
        del q, k, v, calls
        torch.cuda.empty_cache()
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "compare_flash_fwd.json").write_text(json.dumps(report, indent=1))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
