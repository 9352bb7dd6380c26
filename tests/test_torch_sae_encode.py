"""The SAE encoder's split fp32 product (`ops/sae_encode.py`,
`csrc/sae_encode.cu`) on the CPU: the three-way bf16 split is exact, the
plain split product is as close to float64 as fp32 `torch.matmul`, the rule
`pre_acts` follows picks the kernel for every fitting SAE that is not being
trained, whatever the grad mode, the encode's gradients are the matmul
path's, the general attribution path's clean and ablated forwards take one
encoder (a feature outside every top-k keeps a saliency of exactly 0), and
the weight's planes are held for one weight a device and split again after
an in-place update.  The kernel itself is held against the plain version
and against float64 on the card by chip_smoke.py."""

import gc
import re

import numpy as np
import pytest
import torch

from multimodal_sae_tpu_torch import kernels
from multimodal_sae_tpu_torch.models.quant import quantize_weight
from multimodal_sae_tpu_torch.ops import sae_encode as se
from multimodal_sae_tpu_torch.sae import model as sae_model


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.int32)


def _normal_values(seed: int, n: int = 200_000) -> torch.Tensor:
    """Seeded fp32 values of both signs, uniform mantissas and every biased
    exponent from 17 (2^-110) to 254 (the largest finite), with the edges:
    FLT_MAX, the last values that round to a finite bf16 and the first that
    would not, values that round up to the next power of two, 2^-110."""
    rng = np.random.default_rng(seed)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exponent = rng.integers(17, 255, n, dtype=np.uint32) << 23
    mantissa = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    edges = np.array([0x7F7FFFFF, 0x7F7F7FFF, 0x7F7F8000, 0x7F7F8001, 0x3FFFFFFF, 0x3F7FFFFF, 0x3F7F8000,
                      0x08800000], dtype=np.uint32)
    bits = np.concatenate([sign | exponent | mantissa, edges, edges | (1 << 31)])
    return torch.from_numpy(bits.view(np.float32).copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_split_is_exact_across_signs_and_normal_exponents(seed):
    a = _normal_values(seed)
    assert bool((a.abs() >= 2.0 ** -110).all()) and bool(torch.isfinite(a).all())
    planes = se.split_plain(a)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, *a.shape)
    assert bool(torch.isfinite(planes.float()).all())
    # a1 + a2 is the residual a - a0, itself an fp32 value, so this order
    # of fp32 adds is exact (a0 + a1 first could pass FLT_MAX).
    total = planes[0].float() + (planes[1].float() + planes[2].float())
    np.testing.assert_array_equal(_bits(total), _bits(a))
    assert torch.equal(planes.double().sum(0), a.double())
    # Each plane is a step smaller: 2^-8 and 2^-16 of |a| (2^-7 and 2^-15
    # where a0 was truncated to stay finite).
    assert bool((planes[1].float().abs() <= a.abs() * 2.0 ** -7).all())
    assert bool((planes[2].float().abs() <= a.abs() * 2.0 ** -15).all())
    rounded = torch.isfinite(a.to(torch.bfloat16))
    assert bool((planes[1].float().abs()[rounded] <= a.abs()[rounded] * 2.0 ** -8).all())


def test_the_split_below_the_exact_range_loses_under_bf16s_smallest_step():
    rng = np.random.default_rng(5)
    a = torch.from_numpy((rng.standard_normal(10_000) * 2.0 ** -115).astype(np.float32))
    planes = se.split_plain(a)
    total = planes[0].float() + (planes[1].float() + planes[2].float())
    assert float((total.double() - a.double()).abs().max()) <= 2.0 ** -133


def _released_scales(seed: int, rows: int = 32, d_in: int = 4096, latents: int = 512):
    """Hiddens at a residual stream's scale, stored bf16 as the subject
    hands them over, with a few large channels; W_enc ~ U(+-1/64), the
    released initialisation at d_in 4,096; small biases."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d_in)) * 3.0
    x[:, rng.integers(0, d_in, 8)] *= 40.0
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    W = torch.from_numpy(rng.uniform(-1 / 64, 1 / 64, (d_in, latents)).astype(np.float32))
    b_enc = torch.from_numpy((rng.standard_normal(latents) * 0.05).astype(np.float32))
    b_dec = torch.from_numpy((rng.standard_normal(d_in) * 0.2).astype(np.float32))
    return x, W, b_enc, b_dec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_plain_split_product_is_as_close_to_float64_as_fp32_matmul(seed):
    x, W, b_enc, b_dec = _released_scales(seed)
    a = x.float() - b_dec  # the product's fp32 operand, as pre_acts forms it
    exact = torch.relu(a.double() @ W.double() + b_enc.double())
    got = se.encode_plain(x, W, b_enc, b_dec)
    library = (a @ W).add_(b_enc).relu_()
    assert got.dtype == torch.float32 and got.shape == exact.shape
    err = (got.double() - exact).abs()
    lib_err = (library.double() - exact).abs()
    assert float(err.max()) <= 2 * float(lib_err.max())
    assert float(err.mean()) <= 2 * float(lib_err.mean())
    # The encode of a CPU tensor is the plain version.
    torch.testing.assert_close(se.encode(x, W, b_enc, b_dec), got, rtol=0, atol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the rule reads `is_cuda`
    and never touches the data."""

    @property
    def is_cuda(self):
        return True


def _card(t: torch.Tensor, requires_grad: bool = False) -> torch.Tensor:
    t = t.clone().requires_grad_(requires_grad)
    return t.as_subclass(_OnCard)


def _tensors(d_in=128, latents=256, rows=4, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(rows, d_in, generator=g), torch.randn(d_in, latents, generator=g).to(dtype),
            torch.randn(latents, generator=g).to(dtype), torch.randn(d_in, generator=g).to(dtype))


def test_the_rule_takes_the_kernel_under_no_grad_for_a_fitting_fp32_weight():
    x, W, b_enc, b_dec = (_card(t) for t in _tensors())
    with torch.no_grad():
        assert se.takes(x, W, b_enc, b_dec)
    # No tensor asks for a gradient: nothing to record under grad mode either.
    assert se.takes(x, W, b_enc, b_dec)
    # Leading dimensions and bf16 hiddens are taken as they are.
    with torch.no_grad():
        assert se.takes(_card(torch.zeros(2, 3, 128, dtype=torch.bfloat16)), W, b_enc, b_dec)


@pytest.mark.parametrize("grad_on", ["x", "W_enc", "b_enc", "b_dec"])
def test_the_rule_keeps_matmul_only_for_a_weight_being_trained(grad_on):
    names = ("x", "W_enc", "b_enc", "b_dec")
    tensors = [_card(t, requires_grad=name == grad_on) for name, t in zip(names, _tensors())]
    assert se.takes(*tensors) == (grad_on != "W_enc")
    with torch.no_grad():
        assert se.takes(*tensors) == (grad_on != "W_enc")


@pytest.mark.parametrize("case", ["cpu", "quantised", "bf16_weight", "d_in_126", "latents_200", "no_rows",
                                  "x_width", "integer_x"])
def test_the_rule_keeps_matmul_where_the_kernel_does_not_fit(case):
    x, W, b_enc, b_dec = _tensors()
    on_card = True
    if case == "cpu":
        on_card = False
    elif case == "quantised":
        W = quantize_weight(W.t(), dim=1)
    elif case == "bf16_weight":
        x, W, b_enc, b_dec = _tensors(dtype=torch.bfloat16)
    elif case == "d_in_126":
        x, W, b_enc, b_dec = _tensors(d_in=63 * 2)
    elif case == "latents_200":
        x, W, b_enc, b_dec = _tensors(latents=200)
    elif case == "no_rows":
        x = x[:0]
    elif case == "x_width":
        x = torch.zeros(4, 64)
    elif case == "integer_x":
        x = torch.zeros(4, 128, dtype=torch.int32)
    if on_card:
        x, b_enc, b_dec = _card(x), _card(b_enc), _card(b_dec)
        W = W if isinstance(W, dict) else _card(W)
    with torch.no_grad():
        assert not se.takes(x, W, b_enc, b_dec)


def test_pre_acts_on_the_cpu_keeps_matmul_bit_for_bit(monkeypatch):
    def refuse(*args):
        raise AssertionError("the kernel ran on a CPU tensor")

    monkeypatch.setattr(se, "encode", refuse)
    x, W, b_enc, b_dec = _tensors()
    params = {"W_enc": W, "b_enc": b_enc, "b_dec": b_dec}
    with torch.no_grad():
        got = sae_model.pre_acts(params, x)
    torch.testing.assert_close(got, ((x - b_dec) @ W).add_(b_enc).relu_(), rtol=0, atol=0)


def test_pre_acts_runs_the_kernel_where_the_rule_admits_it(monkeypatch):
    calls = []
    monkeypatch.setattr(se, "takes", lambda *t: True)
    monkeypatch.setattr(se, "encode", lambda *t: calls.append(t) or torch.zeros(()))
    x, W, b_enc, b_dec = _tensors()
    sae_model.pre_acts({"W_enc": W, "b_enc": b_enc, "b_dec": b_dec}, x)
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] is W


def test_pre_acts_gradient_under_grad_is_unchanged():
    x, W, b_enc, b_dec = _tensors()
    params = {k: v.clone().requires_grad_(True) for k, v in (("W_enc", W), ("b_enc", b_enc), ("b_dec", b_dec))}
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    assert not se.takes(_card(x), _card(W, requires_grad=True), _card(b_enc), _card(b_dec))
    g = torch.randn(4, 256, generator=torch.Generator().manual_seed(1))
    (sae_model.pre_acts(params, x) * g).sum().backward()
    (torch.relu((x - ref["b_dec"]) @ ref["W_enc"] + ref["b_enc"]) * g).sum().backward()
    for name in params:
        torch.testing.assert_close(params[name].grad, ref[name].grad, rtol=0, atol=0)


def test_the_weight_planes_are_kept_and_split_again_after_an_in_place_update():
    W = torch.randn(128, 256, generator=torch.Generator().manual_seed(2))
    first = se.weight_planes(W)
    assert se.weight_planes(W) is first
    torch.testing.assert_close(first, se.split_plain(W), rtol=0, atol=0)
    with torch.no_grad():
        W.mul_(1.5)
    again = se.weight_planes(W)
    assert again is not first
    torch.testing.assert_close(again, se.split_plain(W), rtol=0, atol=0)
    assert se.weight_planes(W) is again
    device = W.device
    del W, first, again
    gc.collect()
    assert device not in se._planes


def test_the_planes_are_held_for_one_weight_a_device():
    g = torch.Generator().manual_seed(3)
    W1, W2 = torch.randn(128, 256, generator=g), torch.randn(128, 256, generator=g)
    first = se.weight_planes(W1)
    second = se.weight_planes(W2)
    assert len(se._planes) == 1 and se._planes[W2.device][0]() is W2
    again = se.weight_planes(W1)
    assert again is not first and se._planes[W1.device][0]() is W1
    torch.testing.assert_close(again, se.split_plain(W1), rtol=0, atol=0)
    torch.testing.assert_close(second, se.split_plain(W2), rtol=0, atol=0)
    # The planes of a weight that dies after another was split stay freed.
    del W2, second
    gc.collect()
    assert se._planes[W1.device][0]() is W1


@pytest.mark.parametrize("grad_on", ["x", "W_enc", "b_enc", "b_dec"])
def test_the_encodes_gradient_is_the_matmul_paths(grad_on):
    x, W, b_enc, b_dec = _tensors(rows=16)
    mine = {"x": x, "W_enc": W, "b_enc": b_enc, "b_dec": b_dec}
    mine = {n: t.clone().requires_grad_(n == grad_on) for n, t in mine.items()}
    ref = {n: t.detach().clone().requires_grad_(n == grad_on) for n, t in mine.items()}
    got = se.encode(mine["x"], mine["W_enc"], mine["b_enc"], mine["b_dec"])
    want = ((ref["x"] - ref["b_dec"]) @ ref["W_enc"]).add_(ref["b_enc"]).relu_()
    assert torch.equal(got > 0, want > 0)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(4))
    (got * g).sum().backward()
    (want * g).sum().backward()
    torch.testing.assert_close(mine[grad_on].grad, ref[grad_on].grad, rtol=0, atol=0)
    assert all(t.grad is None for n, t in mine.items() if n != grad_on)


def test_an_encode_gives_the_same_bits_with_and_without_a_graph():
    x, W, b_enc, b_dec = _released_scales(6, rows=8, d_in=128, latents=256)
    with torch.no_grad():
        clean = se.encode(x, W, b_enc, b_dec)
    h = x.float().requires_grad_()
    ablated = se.encode(h, W, b_enc, b_dec)
    assert ablated.requires_grad
    torch.testing.assert_close(ablated.detach(), clean, rtol=0, atol=0)


def test_the_general_path_takes_one_encoder_in_its_clean_and_ablated_forwards(monkeypatch):
    """Two hookpoints of a tiny fp32 LLaMA with the encode taken as on the
    card (the rule told the CPU tensors fit, so `encode`'s Function runs the
    plain split product): the clean forward runs under no_grad, each
    feature's forward under grad with the upper splice's input requiring
    grad, and both go through `encode`.  A feature outside every top-k then
    leaves both splices unchanged bit for bit: its saliency is exactly 0."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.patching import general_attribution_maps, get_logit_diff
    from multimodal_sae_tpu_torch.features.patching import spliced_forward_with_delta
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae

    monkeypatch.setattr(se, "_fits", lambda *t: True)
    encodes, real = [], se.encode
    monkeypatch.setattr(se, "encode", lambda x, *t: encodes.append(x.requires_grad) or real(x, *t))
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.float32, device="cpu")
    hooks = ("layers.0", "layers.1")
    saes = {h: Sae(64, SaeConfig(num_latents=256, k=4), seed=i, device="cpu") for i, h in enumerate(hooks, 1)}
    batch = {"input_ids": np.random.default_rng(0).integers(1, 128, size=(1, 20))}
    with torch.no_grad():
        _, clean = spliced_forward_with_delta(model, batch, saes, {h: torch.zeros(1, 20, 64) for h in hooks})
        h = model.forward(batch, capture=hooks, interventions={hooks[0]: lambda x: clean[hooks[0]]})["captured"]
    tops = [set(saes[n].encode(h[n].reshape(-1, 64)).top_indices.reshape(-1).tolist()) for n in hooks]
    inside = sorted(tops[0])[0]
    outside = min(set(range(256)) - tops[0] - tops[1])
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[3, 4]]))
    encodes.clear()
    out = general_attribution_maps(model, saes, batch, metric, [inside, outside], progress=False)
    # The clean forward's two encodes without a graph, each feature's lower
    # one without and its upper one with.
    assert encodes == [False, False] + [False, True] * 2
    for name in hooks:
        assert np.any(out[name][0] != 0)
        assert not np.any(out[name][1] != 0), f"a feature outside every top-k moved {name}"


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    x, W, b_enc, b_dec = (t.to("meta") for t in _tensors())
    with pytest.raises(ValueError):
        se.encode(x, W, b_enc, b_dec)
    with pytest.raises(ValueError):
        se.split(torch.zeros(4, 8, device="meta"))


def _code() -> str:
    src = kernels.CUDA_SOURCES["sae_encode"].read_text()
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_the_kernel_runs_six_bf16_products_into_two_accumulators_and_no_lower_precision():
    code = _code()
    products = re.findall(r"wgmma_ss<BN, 1>\((c\d), da(\d), db(\d), [^)]*\);", code)
    assert sorted((a, b) for _, a, b in products) == sorted(
        [("0", "0"), ("0", "1"), ("1", "0"), ("0", "2"), ("1", "1"), ("2", "0")])
    assert [acc for acc, a, b in products if (a, b) == ("0", "0")] == ["c0"]
    assert {acc for acc, a, b in products if (a, b) != ("0", "0")} == {"c1"}
    # Both accumulators go into the fp32 sum with round-to-nearest adds.
    assert re.search(r"sum\[i\] \+= c0\[i\] \+ c1\[i\];", code)
    for word in ("tf32", "f16.f16", ".f16 ", "e4m3", "e5m2", "__half"):
        assert word not in code
    assert ".f32.bf16.bf16" in (kernels.CSRC / "sm90.cuh").read_text()
    # No term is skipped on a value: the product loop has no data test.
    loop = code[code.index("wgmma_fence();"):code.index("wgmma_commit();")]
    assert "if" not in loop


def test_the_kernel_is_warp_specialised_and_persistent():
    code = _code()
    assert "setmaxnreg.dec.sync.aligned" in code and "setmaxnreg.inc.sync.aligned" in code
    assert re.search(r"for \(int t = blockIdx\.x; t < n_tiles; t \+= gridDim\.x\)", code)
    stages = int(re.search(r"constexpr int STAGES = (\d+);", code).group(1))
    assert stages >= 2 and 1 + 3 * stages <= 15
    assert "atomic" not in code
