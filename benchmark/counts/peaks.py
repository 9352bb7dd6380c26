"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
full 700 W power limit).  A share is stated against these, with the card's
power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
"""fp32 on the CUDA cores (33.5 T FMAs/s): the SAE's products run with TF32
off, as parity with the reference requires."""
INT8_OPS = 1979e12
