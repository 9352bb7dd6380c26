"""Block max (kernel K1's function) in the PyTorch port against the JAX
package: the Pallas kernel in interpret mode at block 128, and XLA's
reshape-max at the blocks the port's top-k uses (64, 8).  Bit-exact: a max
never rounds.  The CUDA kernel itself is held against the same plain version
on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.ops.pallas_topk import pallas_block_max
from multimodal_sae_tpu_torch.ops import block_max as bm


def _inputs(shape, dtype, seed=0, special=None):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    for where, value in special or ():
        x[where] = value
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))  # both round to nearest even
    return jx, tx


def _assert_bits_equal(jax_out, torch_out):
    a = np.asarray(jax_out, np.float32)
    b = torch_out.float().numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.int32), b[ok].view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_block_max_matches_pallas_interpret(dtype):
    jx, tx = _inputs((16, 32768), dtype)
    got = bm.block_max(tx, 128)
    assert got.dtype == tx.dtype and got.shape == (16, 256)
    _assert_bits_equal(pallas_block_max(jx, 128, interpret=True), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block,width", [(64, 131072), (8, 16384)])
def test_plain_block_max_matches_reshape_max(dtype, block, width):
    """The main path's two reduces, with +inf, -inf and NaN entries: a block
    holding NaN gives NaN (as `torch.amax` and XLA's max propagate it), a
    block of -inf gives -inf."""
    special = [((2, 77), np.nan), ((1, 5), np.inf), ((3, slice(0, block)), -np.inf)]
    jx, tx = _inputs((4, width), dtype, seed=1, special=special)
    ref = jx.reshape(4, width // block, block).max(axis=-1)
    got = bm.block_max(tx, block)
    _assert_bits_equal(ref, got)
    assert torch.isnan(got[2, 77 // block])
    assert got[1, 0] == float("inf") and got[3, 0] == float("-inf")


@pytest.mark.parametrize(
    "shape,block",
    [
        ((4, 64), 7),  # not a block the kernel takes
        ((4, 4096), 256),  # above 128
        ((4, 60), 8),  # W not a multiple of the block
        ((2, 4, 64), 8),  # not 2-D
    ],
)
def test_block_max_rejects_shapes(shape, block):
    with pytest.raises(ValueError):
        bm.block_max(torch.zeros(shape), block)


def test_block_max_dispatch_on_cpu_counts_nothing():
    """A CPU tensor takes the plain version and leaves the launch count at
    0; a tensor elsewhere than cpu or cuda is refused."""
    bm.launches = 0
    x = torch.randn(4, 64)
    assert torch.equal(bm.block_max(x, 8), bm.block_max_plain(x, 8))
    assert bm.launches == 0
    with pytest.raises(ValueError):
        bm.block_max(torch.zeros(4, 64, device="meta"), 8)
