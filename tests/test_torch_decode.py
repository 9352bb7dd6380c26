"""The sparse decode of the PyTorch port against the JAX package: the row
gather (kernel K2's function) bit-exact against `pallas_gather_rows` run in
interpret mode, as tests/test_pallas_gather.py runs it; `gather_decode`,
`eager_decode`, `scatter_dense` and `Sae.decode` on the same weights and
inputs.  Tolerances: fp32 rtol 1e-5 (sums of k products in different
orders); bf16 one ulp (2^-8) of the largest output, both sides summing in
fp32 and rounding once.  `sparse_decode`'s backward is held against the
dense scatter's autograd here and against the JAX package's VJP in
tests/test_torch_train_ops.py.  The CUDA kernel is held against the same
plain versions on the card by chip_smoke.py."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.ops.sparse_decode import eager_decode as jax_eager_decode
from multimodal_sae_tpu.ops.sparse_decode import gather_decode as jax_gather_decode
from multimodal_sae_tpu.ops.sparse_decode import scatter_dense as jax_scatter_dense
from multimodal_sae_tpu.ops.pallas_gather import pallas_gather_rows
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax, tensor_from_numpy, tensor_to_numpy
from multimodal_sae_tpu_torch.ops import gather_rows as gr
from multimodal_sae_tpu_torch.sae import Sae, decode

# The module: `ops.sparse_decode` is the function the package exports.
sd = importlib.import_module("multimodal_sae_tpu_torch.ops.sparse_decode")

RTOL = 1e-5


def _topk_inputs(n, k, L, seed=0):
    """Unique indices per row (as from a top-k) and post-ReLU activations."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(L, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    vals = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M", [8, 24])
def test_gather_rows_matches_pallas_interpret(dtype, M):
    """Bit-exact against the TPU kernel in interpret mode at its own limits
    (d = 2048, M a multiple of 8)."""
    rng = np.random.default_rng(1)
    W = jnp.asarray(rng.normal(size=(50, 2048)), dtype)
    idx = rng.integers(0, 50, size=M).astype(np.int32)
    ref = np.asarray(pallas_gather_rows(W, jnp.asarray(idx), interpret=True))
    got = gr.gather_rows(tensor_from_numpy(np.asarray(W), "cpu"), torch.from_numpy(idx))
    np.testing.assert_array_equal(tensor_to_numpy(got), ref)


def test_gather_rows_has_no_tpu_limits():
    """Any M and d: W[idx], bit for bit, repeats included."""
    W = torch.randn(37, 12)
    idx = torch.tensor([3, 3, 0, 36, 5], dtype=torch.int32)
    assert torch.equal(gr.gather_rows(W, idx), W[idx.long()])
    with pytest.raises(ValueError):
        gr.gather_rows(W, idx[None])
    assert gr.launches == 0


@pytest.mark.parametrize("lead", [(7,), (2, 5)], ids=["flat", "batched"])
def test_gather_and_eager_decode_match_jax(lead):
    n = int(np.prod(lead))
    idx, vals = _topk_inputs(n, 6, 40)
    idx, vals = idx.reshape(*lead, 6), vals.reshape(*lead, 6)
    W = np.random.default_rng(2).normal(size=(40, 24)).astype(np.float32)
    ref = np.asarray(jax_gather_decode(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(W)))
    ref_eager = np.asarray(jax_eager_decode(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(W)))
    ti, tv, tW = torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(W)
    got = sd.gather_decode(ti, tv, tW)
    assert got.shape == (*lead, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(sd.eager_decode(ti, tv, tW).numpy(), ref_eager, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(sd.sparse_decode(ti, tv, tW).numpy(), ref, rtol=RTOL, atol=1e-6)


def test_scatter_dense_matches_jax():
    idx, vals = _topk_inputs(5, 4, 16, seed=3)
    ref = np.asarray(jax_scatter_dense(jnp.asarray(idx), jnp.asarray(vals), 16))
    np.testing.assert_array_equal(sd.scatter_dense(torch.from_numpy(idx), torch.from_numpy(vals), 16).numpy(), ref)


def test_bf16_gather_decode_matches_jax():
    idx, vals = _topk_inputs(9, 8, 64, seed=4)
    W = np.random.default_rng(5).normal(size=(64, 32)).astype(np.float32)
    jv, jW = jnp.asarray(vals, jnp.bfloat16), jnp.asarray(W, jnp.bfloat16)
    ref = np.asarray(jax_gather_decode(jnp.asarray(idx), jv, jW)).astype(np.float32)
    got = gr.gather_decode(torch.from_numpy(idx), tensor_from_numpy(np.asarray(jv), "cpu"),
                           tensor_from_numpy(np.asarray(jW), "cpu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2.0**-8 * np.abs(ref).max())


def test_sae_decode_matches_jax():
    """`Sae.decode` (sparse decode + b_dec) on weights carried across, with
    a nonzero b_dec, and the encode -> decode round trip."""
    jsae = JaxSae(16, JaxSaeConfig(num_latents=64, k=4), key=jax.random.PRNGKey(0))
    jsae.params["b_dec"] = jnp.asarray(np.random.default_rng(6).normal(size=16).astype(np.float32))
    sae = Sae(16, SaeConfig(num_latents=64, k=4),
              params=sae_params_from_jax({k: np.asarray(v) for k, v in jsae.params.items()}, device="cpu"))
    idx, vals = _topk_inputs(10, 4, 64, seed=7)
    ref = np.asarray(jsae.decode(jnp.asarray(vals), jnp.asarray(idx)))
    got = sae.decode(torch.from_numpy(vals), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6)
    x = np.random.default_rng(8).normal(size=(3, 16)).astype(np.float32)
    jenc = jsae.encode(jnp.asarray(x))
    enc = sae.encode(torch.from_numpy(x))
    np.testing.assert_allclose(sae.decode(*enc).numpy(),
                               np.asarray(jsae.decode(jenc.top_acts, jenc.top_indices)), rtol=RTOL, atol=1e-6)


def test_decode_needs_the_decoder(tmp_path):
    Sae(8, SaeConfig(num_latents=16, k=2), device="cpu").save_to_disk(tmp_path / "s")
    sae = Sae.load_from_disk(tmp_path / "s", decoder=False, device="cpu")
    with pytest.raises(KeyError):
        decode(sae.params, torch.ones(1, 2), torch.zeros(1, 2, dtype=torch.int32))


def test_sparse_decode_refuses_grad():
    """The decode once refused autograd; it now has the JAX package's VJP
    (dvals = g . W[idx], dW = S^T g): both gradients equal the dense
    scatter's autograd within 1e-5 (fp32 sums in other orders), the indices
    get none, and without autograd it decodes as before."""
    idx, vals = _topk_inputs(3, 2, 8)
    ti, tv, tW = torch.from_numpy(idx), torch.from_numpy(vals), torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    g = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))
    got_v, got_W = tv.clone().requires_grad_(), tW.clone().requires_grad_()
    ref_v, ref_W = tv.clone().requires_grad_(), tW.clone().requires_grad_()
    (sd.sparse_decode(ti, got_v, got_W) * g).sum().backward()
    (sd.eager_decode(ti, ref_v, ref_W) * g).sum().backward()
    assert torch.allclose(got_v.grad, ref_v.grad, rtol=RTOL, atol=1e-6)
    assert torch.allclose(got_W.grad, ref_W.grad, rtol=RTOL, atol=1e-6)
    with torch.no_grad():
        out = sd.sparse_decode(ti, tv.clone().requires_grad_(), tW)
    assert torch.allclose(out, sd.eager_decode(ti, tv, tW), rtol=RTOL, atol=1e-6)