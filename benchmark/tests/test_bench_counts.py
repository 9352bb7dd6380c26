"""The frozen counts reproduce the kernel bounds that the port's kernel
table states at its shapes, and the whole step's operations as reckoned."""

import pytest

from benchmark import harness
from benchmark.counts import work


def test_k1_bounds():
    assert work.k1_bound_s(16384, 131072, 64) * 1e3 == pytest.approx(2.604, abs=5e-4)
    assert work.k1_bound_s(16384, 16384, 8) * 1e3 == pytest.approx(0.361, abs=5e-4)
    assert work.topk_k1_bound_s(16384, 131072, 256) * 1e3 == pytest.approx(2.604 + 0.361, abs=1e-3)


def test_k3_bounds():
    assert work.k3_fwd_bound_s(8, 32, 8, 2048, 128)["s"] * 1e3 == pytest.approx(0.278, abs=5e-4)
    assert work.k3_bwd_bound_s(8, 32, 8, 2432, 128)["s"] * 1e3 == pytest.approx(0.980, abs=5e-4)
    # The image batch right-padded to 2,929: the kernel table's 0.253 ms
    # counts the pad queries' pairs too; only the valid rows' causal work
    # is required.
    padded = work.k3_fwd_bound_s(4, 32, 8, 2929, 128, [2341, 1177, 2329, 2929])["s"]
    assert padded * 1e3 == pytest.approx(0.1729, abs=5e-4)


def test_step_operations():
    """A 16,384-token text slice at the cell's widths: about 188 ms of bf16
    subject (25 layers) and 263 ms of fp32 encode at the peaks."""
    text = harness.load_json(harness.BENCH_DIR / "configs" / "mistral-7b-instruct-v0.2.json")
    subject = {"kind": "llama", "text": text, "layers": 25, "B": 8, "S": 2048, "valid": [2048] * 8}
    encode = {"kind": "sae_encode", "d_in": 4096, "latents": 131072, "k": 256, "rows": 16384, "positions": 16384}
    assert work.ideal_seconds([subject]) * 1e3 == pytest.approx(188, rel=0.01)
    assert work.ideal_seconds([encode]) * 1e3 == pytest.approx(263, rel=0.01)
    assert work.llama_layer_params(text) == 218_103_808


def test_pads_are_not_counted():
    text = harness.load_json(harness.BENCH_DIR / "configs" / "mistral-7b-instruct-v0.2.json")
    a = {"kind": "llama", "text": text, "layers": 25, "B": 2, "S": 100, "valid": [100, 40]}
    b = {"kind": "llama", "text": text, "layers": 25, "B": 2, "S": 400, "valid": [100, 40]}
    assert work.ideal_seconds([a]) == work.ideal_seconds([b])
