"""The operations and bytes the benchmark's cells require, computed from
the shapes a driver records for each unit of work, and the bounds of the
port's kernels at their launch shapes.

Counts are of what the algorithm needs at these inputs: pad positions,
recomputation and a dense product where a sparse one suffices are not
counted.  Work items (dicts a driver appends to `ctx.work`):

    {"kind": "llama", "text": cfg, "layers": L, "B": B, "S": S, "valid": [n_b]}
        L decoder layers over B right-padded rows of S positions.
    {"kind": "clip", "vision": cfg, "tiles": n, "layers": L}
        the tower's first L layers over n 336 x 336 tiles, and the projector.
    {"kind": "sae_encode", "d_in": d, "latents": L, "rows": n, "positions": m}
        n valid rows encoded of m encoded positions.
"""

from __future__ import annotations

from typing import Dict, Iterable

from .peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S


def llama_layer_params(text: dict) -> int:
    D, I = text["hidden_size"], text["intermediate_size"]
    H, kvH = text["num_attention_heads"], text["num_key_value_heads"]
    hd = text.get("head_dim") or D // H
    return D * H * hd + 2 * D * kvH * hd + H * hd * D + 3 * D * I


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal row of n valid positions."""
    return n * (n + 1) // 2


def llama_flops(item: dict) -> float:
    """bf16 operations of `layers` decoder layers over the valid positions:
    the projections and MLP at 2 per weight a token, the attention at
    4 * hd a head per causal pair (QK^T and PV)."""
    text, L = item["text"], item["layers"]
    H = text["num_attention_heads"]
    hd = text.get("head_dim") or text["hidden_size"] // H
    tokens = sum(item["valid"])
    pairs = sum(causal_pairs(n) for n in item["valid"])
    return L * (2.0 * llama_layer_params(text) * tokens + 4.0 * hd * H * pairs)


def clip_flops(item: dict) -> float:
    """bf16 operations of the tower's first `layers` layers over `tiles`
    tiles (the patch product, full attention over 1 + P tokens), and the
    projector over the P patch tokens of each tile."""
    v, L, n = item["vision"], item["layers"], item["tiles"]
    D, I, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    P = (v["image_size"] // p) ** 2
    T = P + 1
    Dt = item["text_hidden"]
    per_tile = 2.0 * P * 3 * p * p * D
    per_tile += L * (2.0 * T * (4 * D * D + 2 * D * I) + 4.0 * D * T * T)
    per_tile += 2.0 * P * (D * Dt + Dt * Dt)
    return n * per_tile


def encode_flops(item: dict) -> float:
    """fp32 operations of the SAE encoder over the valid rows."""
    return 2.0 * item["d_in"] * item["latents"] * item["rows"]


def ideal_seconds(work: Iterable[dict]) -> float:
    """The least time the window's required operations take, each at the
    peak of its precision."""
    total = 0.0
    for item in work:
        kind = item["kind"]
        if kind == "llama":
            total += llama_flops(item) / BF16_FLOPS
        elif kind == "clip":
            total += clip_flops(item) / BF16_FLOPS
        elif kind == "sae_encode":
            total += encode_flops(item) / FP32_FLOPS
    return total


def k3_fwd_bound_s(B: int, H: int, kvH: int, S: int, hd: int, valid=None) -> Dict[str, float]:
    """K3 forward at one launch: 4 * hd operations per causal pair of valid
    queries and keys against q, k, v read and o written (bf16) over the
    valid positions; the bound is the larger."""
    valid = [S] * B if valid is None else list(valid)
    flops = 4.0 * hd * H * sum(causal_pairs(n) for n in valid)
    nbytes = 2.0 * sum(valid) * (2 * H * hd + 2 * kvH * hd)
    return {"flops_s": flops / BF16_FLOPS, "bytes_s": nbytes / HBM_BYTES_PER_S,
            "s": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)}


def k3_bwd_bound_s(B: int, H: int, kvH: int, S: int, hd: int) -> Dict[str, float]:
    """K3 backward at one (delta, dK/dV, dQ) launch set, unpadded: 10 * hd
    operations per causal pair; q, o, do, dq and k, v, dk, dv moved once
    (bf16), the fp32 logsumexp read."""
    pairs = B * H * causal_pairs(S)
    flops = 10.0 * hd * pairs
    nbytes = (4 * B * H * S * hd + 4 * B * kvH * S * hd) * 2 + B * H * S * 4
    return {"flops_s": flops / BF16_FLOPS, "bytes_s": nbytes / HBM_BYTES_PER_S,
            "s": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)}


def k1_bound_s(rows: int, width: int, block: int, itemsize: int = 4) -> float:
    """K1 (block max) at one launch: the (rows, width) input read and the
    (rows, width / block) maxima written."""
    return (rows * width + rows * width // block) * itemsize / HBM_BYTES_PER_S


def topk_k1_bound_s(rows: int, latents: int, k: int, block: int = 64, block2: int = 8) -> float:
    """The exact top-k's two K1 launches over `rows` encoded positions: the
    latents in blocks of `block`, then the k * block candidates in blocks
    of `block2` (ops/topk.py `blockmax_top_k`)."""
    return k1_bound_s(rows, latents, block) + k1_bound_s(rows, k * block, block2)
