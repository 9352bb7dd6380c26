"""The port's exact k-th value searches (ops/topk.py `kth_value`,
`kth_value_bitwise`, `kth_value_histogram`) against the JAX package's bits,
on float16, bf16, float32 and float64 (the latter under
`jax.enable_x64`): edge rows (all -inf, mostly -inf, signed
zeros, +inf, ties at the k-th place) and tests/test_topk_fuzz.py's
adversarial rows, at k = 1 through the width."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import enable_x64

import multimodal_sae_tpu.ops.topk as jax_topk
from multimodal_sae_tpu_torch import ops
from multimodal_sae_tpu_torch.convert import tensor_from_numpy
from multimodal_sae_tpu_torch.ops import topk

WIDTH = 512
DTYPES = {"f16": (np.float16, np.int16), "bf16": (ml_dtypes.bfloat16, np.int16), "f32": (np.float32, np.int32),
          "f64": (np.float64, np.int64)}
FORMS = ("kth_value", "kth_value_bitwise", "kth_value_histogram")
KS = (1, 7, 256, 511, WIDTH)


def _rows() -> np.ndarray:
    """(14, 512) float64 rows: the fuzz test's adversarial rows, then edges."""
    rng = np.random.default_rng(7)
    rows = [
        rng.normal(size=WIDTH),
        np.zeros(WIDTH),                                      # all ties at 0
        np.full(WIDTH, 2.5),                                  # all ties, nonzero
        np.repeat(rng.normal(size=64), 8),                    # heavy ties
        np.concatenate([np.full(500, -np.inf), rng.normal(size=12)]),
        -np.abs(rng.normal(size=WIDTH)),                      # all negative
        np.full(WIDTH, -np.inf),                              # every entry -inf
        np.where(np.arange(WIDTH) % 2 == 0, -0.0, 0.0),       # signed zeros, -0.0 below +0.0
        np.concatenate([np.full(5, 0.0), np.full(WIDTH - 5, -0.0)]),
        np.concatenate([rng.normal(size=WIDTH - 100), np.full(100, np.inf)]),
        np.round(rng.normal(size=WIDTH) * 3),                 # ties at most places
        np.where(np.arange(WIDTH) % 2 == 1, -np.inf, np.maximum(rng.normal(size=WIDTH), 0)),  # AuxK's scores
        rng.normal(size=WIDTH) * 1e-30,                       # subnormal in f32 and below, 0 in f16
        np.concatenate([np.full(256, 1.0), np.full(256, 1.0 + 2.0**-40)]),  # apart only in f64
    ]
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def _jax_form(form: str):
    """The JAX form jitted with k traced: one compile per dtype, not per k."""
    return jax.jit(getattr(jax_topk, form))


@functools.lru_cache(maxsize=None)
def _jax_bits(dtype: str, form: str, k: int) -> np.ndarray:
    np_dtype, int_dtype = DTYPES[dtype]
    with enable_x64(dtype == "f64"):
        out = _jax_form(form)(jnp.asarray(_rows().astype(np_dtype)), jnp.int32(k))
        return np.asarray(out).view(int_dtype)


def _port_bits(dtype: str, form: str, k: int, x: np.ndarray = None) -> np.ndarray:
    np_dtype, int_dtype = DTYPES[dtype]
    x = _rows().astype(np_dtype) if x is None else x
    out = getattr(ops, form)(tensor_from_numpy(x, "cpu"), k)
    assert out.shape == (x.shape[0], 1) and out.dtype == tensor_from_numpy(x[:1, :1], "cpu").dtype
    return out.view({np.int16: torch.int16, np.int32: torch.int32, np.int64: torch.int64}[int_dtype]).numpy()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_equals_jax_bits(dtype, form, k):
    """Each form's bits equal the JAX function of the same name's, and all
    three forms give the same bits."""
    got = _port_bits(dtype, form, k)
    np.testing.assert_array_equal(got, _jax_bits(dtype, form, k))
    np.testing.assert_array_equal(got, _jax_bits(dtype, "kth_value_bitwise", k))


@pytest.mark.parametrize("form", FORMS)
def test_rows_in_chunks_and_leading_axes(form, monkeypatch):
    """Rows searched a few at a time, and a (2, 7, width) input, give what
    one pass over the rows gives."""
    x = _rows().astype(np.float32)
    whole = _port_bits("f32", form, 37, x)
    monkeypatch.setattr(topk, "KTH_CHUNK_ELEMENTS", 3 * WIDTH)
    np.testing.assert_array_equal(_port_bits("f32", form, 37, x), whole)
    out = getattr(ops, form)(tensor_from_numpy(x, "cpu").reshape(2, 7, WIDTH), 37)
    assert out.shape == (2, 7, 1)
    np.testing.assert_array_equal(out.reshape(14, 1).view(torch.int32).numpy(), whole)


@pytest.mark.parametrize("form", FORMS)
def test_refuses_what_jax_refuses(form):
    """A non-float input raises TypeError, as JAX's `_monotone_key` does; k
    outside [1, width] raises ValueError."""
    fn = getattr(ops, form)
    with pytest.raises(TypeError, match="float dtype"):
        fn(torch.arange(8).reshape(2, 4), 1)
    with pytest.raises(TypeError, match="float dtype"):
        getattr(jax_topk, form)(jnp.arange(8).reshape(2, 4), 1)
    for k in (0, 5):
        with pytest.raises(ValueError, match="must be in"):
            fn(torch.zeros(2, 4), k)

