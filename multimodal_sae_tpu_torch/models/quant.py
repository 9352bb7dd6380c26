"""int8 quantisation of frozen weights (multimodal_sae_tpu/models/quant.py).

The reference loads its subject in 8 bits (reference
train/sae/sae/__main__.py:66-97).  As in the JAX package, a quantised
matrix is a dict {"q8": int8, "scale": fp32}: symmetric int8 with one scale
per output channel, scale = absmax / 127, rounded half to even.  The port
keeps projections as (out, in) for `F.linear`, so `q8` is (out, in) and
`scale` (out,), one per row, where the JAX package keeps (in, out); an
embedding table stays (V, d) in both, with its scale per hidden unit, (d,).

`qmatmul` runs a quantised product in one of two modes:

* W8A16 (the default): the int8 weight cast to the activations' dtype, the
  product summed in fp32 (bf16 operands on the card with an fp32 output;
  fp32 operands otherwise, exact for int8 weights), then the scale, then
  the cast to the activations' dtype, as the JAX package scales its fp32
  sums before it casts.
* W8A8 (`int8=True`): each row of activations quantised by its absmax,
  then an int8 x int8 -> int32 product (`torch._int_mm`, on the card and on
  the CPU alike), then `* sx * scale`.  The int32 sums are exact.
  `_int_mm` on CUDA needs more than 16 rows and k and n multiples of 8: the
  rows, k and n are padded with zeros, which leave the int32 sums exact,
  and the padding is cut off again.  A shape whose inner dimension does not
  match the weight's raises; no shape takes another product quietly.

Both modes carry a backward to the activations only (the weights are
frozen): dx = (g * scale) @ q8 with fp32 sums, g * scale rounded to bf16
for W8A8 (the JAX package's straight-through custom VJP) and to the
activations' dtype for W8A16 (the gradient of the JAX product).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

QuantizedArray = Dict[str, torch.Tensor]  # {"q8": int8 (out, in), "scale": fp32 (out,)}

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows
INT_MM_MULTIPLE = 8  # ... and k and n multiples of 8


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q8" in w


def _absmax_step(absmax: torch.Tensor) -> torch.Tensor:
    """absmax / 127, correctly rounded on every device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which rounds
    otherwise than the JAX package's (and the CPU's) true division; a
    tensor divisor keeps it a true division."""
    return absmax / torch.full_like(absmax, 127.0)


def quantize_weight(w: torch.Tensor, dim: int = 1) -> QuantizedArray:
    """Symmetric int8 with one scale per slice along the dimension that is
    not `dim`: scale = max |w| over `dim` / 127.  dim=1 for an (out, in)
    projection (a scale per output channel), dim=0 for a (V, d) embedding
    table (a scale per hidden unit, as the JAX package's axis 0)."""
    w32 = w.float()
    scale = _absmax_step(w32.abs().amax(dim=dim))
    safe = torch.where(scale == 0, torch.ones_like(scale), scale).unsqueeze(dim)
    q8 = torch.clamp(torch.round(w32 / safe), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale}


def dequantize_weight(w: QuantizedArray, dim: int = 1, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (w["q8"].float() * w["scale"].unsqueeze(dim)).to(dtype)


def leaf_dtype(w: Union[torch.Tensor, QuantizedArray]) -> torch.dtype:
    """The activations' dtype a (possibly quantised) weight implies: bf16
    for a quantised one (JAX models/quant.py:126-130)."""
    return torch.bfloat16 if is_quantized(w) else w.dtype


def leaf_device(w: Union[torch.Tensor, QuantizedArray]) -> torch.device:
    return w["q8"].device if is_quantized(w) else w.device


def leaf_bytes(tree: Any) -> int:
    """The bytes of every tensor in a parameter tree (dicts and lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(leaf_bytes(v) for v in tree)
    return 0


def _mm_fp32_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n), b holding small integers, with fp32 sums:
    bf16 or fp16 operands with an fp32 output on the card (cuBLAS at the
    tensor cores' rate), fp32 operands otherwise (exact products; the card
    runs them with TF32 off, device.set_precision)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b.to(a.dtype), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int8_mm(xq: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """xq (m, k) int8 @ q8 (n, k) int8 transposed -> (m, n) int32, through
    `torch._int_mm` with the rows padded to 17 and k and n to multiples of
    8 with zeros (the sums stay exact)."""
    m, k = xq.shape
    n, k_w = q8.shape
    if k != k_w:
        raise ValueError(f"int8 product of (m={m}, k={k}) activations with an (n={n}, k={k_w}) weight")
    pm = max(INT_MM_MIN_ROWS, m) - m
    pk = _round_up(k, INT_MM_MULTIPLE) - k
    pn = _round_up(n, INT_MM_MULTIPLE) - n
    if pm or pk:
        xq = F.pad(xq, (0, pk, 0, pm))
    if pk or pn:
        q8 = F.pad(q8, (0, pk, 0, pn))
    out = torch._int_mm(xq, q8.t())
    return out[:m, :n] if (pm or pn) else out


def quantize_rows(x2: torch.Tensor):
    """Each row of x2 (m, k) as int8 by its absmax: (xq int8, sx fp32 (m, 1))."""
    x2 = x2.float()
    sx = _absmax_step(x2.abs().amax(dim=-1, keepdim=True))
    safe = torch.where(sx == 0, torch.ones_like(sx), sx)
    return torch.clamp(torch.round(x2 / safe), -127, 127).to(torch.int8), sx


class _QuantizedMatmul(torch.autograd.Function):
    """x (m, k) @ the quantised weight's transpose, fp32 out; straight-through
    backward to x only."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor, int8: bool) -> torch.Tensor:
        ctx.save_for_backward(q8, scale)
        ctx.x_dtype, ctx.int8 = x2.dtype, int8
        if int8:
            xq, sx = quantize_rows(x2)
            return int8_mm(xq, q8).float() * sx * scale
        return _mm_fp32_sums(x2, q8.t()) * scale

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q8, scale = ctx.saved_tensors
        # W8A8: bf16 operands (JAX models/quant.py:100-112); W8A16: the
        # activations' dtype, as autodiff of the JAX product gives.
        g2 = (g.float() * scale).to(torch.bfloat16 if ctx.int8 else ctx.x_dtype)
        return _mm_fp32_sums(g2, q8).to(ctx.x_dtype), None, None, None


def qmatmul(x: torch.Tensor, w: Union[torch.Tensor, QuantizedArray], int8: bool = False) -> torch.Tensor:
    """`F.linear(x, w)` for a dense (out, in) `w`, or the quantised product
    (module docstring) for a quantised one, in x's dtype."""
    if not is_quantized(w):
        return F.linear(x, w)
    lead = x.shape[:-1]
    out = _QuantizedMatmul.apply(x.reshape(-1, x.shape[-1]), w["q8"], w["scale"], int8)
    return out.to(x.dtype).reshape(*lead, out.shape[-1])


def qembed(w: Union[torch.Tensor, QuantizedArray], ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of a dense or quantised (V, d) table: int8 rows
    gathered, then scaled in fp32 and cast to bf16 (JAX
    models/quant.py:118-123)."""
    if not is_quantized(w):
        return w[ids]
    return (w["q8"][ids].float() * w["scale"]).to(torch.bfloat16)


def tied_head_logits(emb: Union[torch.Tensor, QuantizedArray], h: torch.Tensor) -> torch.Tensor:
    """Logits through a tied head, the (V, d) embedding table: with a
    quantised table its per-hidden-unit scale is folded into the
    activations before the product (JAX models/llama.py:640-655)."""
    if not is_quantized(emb):
        return F.linear(h, emb)
    scaled = (h.float() * emb["scale"]).to(h.dtype)
    return F.linear(scaled, emb["q8"].to(h.dtype))


LLAMA_QUANT_KEYS = frozenset(
    {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj", "lm_head", "embed_tokens"}
)
CLIP_QUANT_KEYS = frozenset({"patch_embedding", "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"})


def _quant_entry(name: str, w, keys, device):
    if is_quantized(w):
        return w
    if device is not None:
        w = w.to(device)
    if name in keys and w.ndim == 2:
        return quantize_weight(w, dim=0 if name == "embed_tokens" else 1)
    return w.to(torch.bfloat16) if w.is_floating_point() else w


def _quantize_tree(params: dict, keys, device) -> dict:
    """Quantise `params` in place, leaf by leaf, the other floating leaves
    cast to bf16, the dtype the quantised products compute in: each leaf is
    replaced as it is done, so a caller that holds no other reference to the
    tree never holds its dense and its int8 form whole at once.  With
    `device`, each leaf moves there before it is quantised, so a tree on the
    host reaches the card in int8."""
    for name in list(params):
        if name == "layers":
            for layer in params["layers"]:
                for key in list(layer):
                    layer[key] = _quant_entry(key, layer[key], keys, device)
        else:
            params[name] = _quant_entry(name, params[name], keys, device)
    return params


def quantize_llama_params(params: dict, device=None) -> dict:
    """Quantise a LLaMA tree's projections, `lm_head` and `embed_tokens`
    (JAX models/quant.py:148-183) in place (`_quantize_tree`)."""
    return _quantize_tree(params, LLAMA_QUANT_KEYS, device)


def quantize_clip_params(params: dict, device=None) -> dict:
    """Quantise a CLIP vision tower's matrices (JAX models/quant.py:191-213)
    in place (`_quantize_tree`)."""
    return _quantize_tree(params, CLIP_QUANT_KEYS, device)
