"""The precisions the reference computes in.

`Precision("fp32")` is the reference: every product in float32 with TF32
off.  The control computes one step lower than the configuration states:
`Precision("fp8")` rounds both operands of every bf16-stated product to
float8 e4m3 (one scale a tensor, its absmax at 448) and accumulates in
float32; `tf32` rounds the operands of a float32-stated product to TF32's
10-bit mantissa (round to nearest even), so the control reads the same on
the CPU and the card."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values through float8 e4m3 with one scale for the tensor."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference's products round their operands: `low` for the
    products the configuration states in bf16 ("fp32" or "fp8"), and
    `encode` for the SAE's float32 products ("fp32" or "tf32")."""

    def __init__(self, low: str = "fp32", encode: str = "fp32"):
        if low not in ("fp32", "fp8") or encode not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {low!r}, {encode!r}")
        self.low, self.encode = low, encode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.low == "fp8" else x.float()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b for a bf16-stated product."""
        return self.operand(a) @ self.operand(b)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w.T, w (out, in), for a bf16-stated product."""
        return self.mm(x, w.T)

    def encode_mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.encode == "tf32":
            return tf32_round(a) @ tf32_round(b)
        return a.float() @ b.float()


def full_precision() -> None:
    """float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
