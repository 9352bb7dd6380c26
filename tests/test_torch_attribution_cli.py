"""The attribution CLI of the port
(`python -m multimodal_sae_tpu_torch.launch.features.attribution_patching`)
against the JAX package's, on one tiny LLaVA-NeXT checkpoint directory
(tests/torch_llava_tiny.py's `write_checkpoint`: numpy-drawn weights, a
word-level tokenizer with `<image>`, a processor) and one probe json of
two rows whose PNG images take different anyres geometries.

Both CLIs load the subject in bf16, whose per-op rounding differs between
XLA and PyTorch; both are pinned to fp32 here by patching the name
`load_subject_model` in each CLI module, with flash attention on (the
port's K3 runs its plain version on the CPU).  Each writes one
`{checkpoint}_{hookpoint with . as _}.safetensors`: the same name, keys,
shapes and dtypes, and values within rtol 1e-4, atol 1e-6 (fp32 on both
sides, other summation orders; the bound tests/test_launch_integration.py
holds the JAX fast path to its general one).  `--tp 2` and `--dp 2` are
refused by the subject loader in one process without two cards; `--remat`
writes the same file as without it."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_sae_tpu.config import AttributionConfig as JaxAttributionConfig
from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch.config import AttributionConfig
from multimodal_sae_tpu_torch.utils.safetensors_io import load_file, read_header

from torch_llava_tiny import images, write_checkpoint

TOL = dict(rtol=1e-4, atol=1e-6)
HOOK = "model.layers.1"


@pytest.fixture(scope="module")
def setup_dirs(tmp_path_factory):
    """(checkpoint dir, SAE dir, probe json)."""
    import jax

    d = tmp_path_factory.mktemp("torch_attr_cli")
    (d / "tiny-llava").mkdir()
    ckpt = write_checkpoint(d / "tiny-llava", seed=7)
    JaxSae(64, JaxSaeConfig(num_latents=64, k=4), key=jax.random.PRNGKey(3)).save_to_disk(d / "saes" / HOOK)
    rows = []
    for i, (img, prompt) in enumerate(zip(images([(50, 70), (90, 40)], seed=8), ["1 <image> 2 3", "7 <image> 8"])):
        img.save(d / f"probe{i}.png")
        rows.append({"prompt": prompt, "answer": str(4 + i), "baseline": str(9 - i), "image": str(d / f"probe{i}.png")})
    (d / "probe.json").write_text(json.dumps(rows))
    return ckpt, str(d / "saes"), str(d / "probe.json")


def _in_fp32(load, fp32):
    """`load` with its `dtype` argument replaced by fp32."""

    @functools.wraps(load)
    def pinned(*args, **kwargs):
        return load(*args, **{**kwargs, "dtype": fp32})

    return pinned


def test_clis_write_the_same_file(setup_dirs, tmp_path, monkeypatch):
    from multimodal_sae_tpu.launch import utils as jax_launch_utils
    from multimodal_sae_tpu.launch.features import attribution_patching as jax_cli
    from multimodal_sae_tpu_torch.launch import utils as port_launch_utils
    from multimodal_sae_tpu_torch.launch.features import attribution_patching as port_cli

    ckpt, sae_dir, probe = setup_dirs
    # Both CLIs pass dtype=bf16 themselves, so the pin overrides it.
    monkeypatch.setattr(jax_cli, "load_subject_model", _in_fp32(jax_launch_utils.load_subject_model, jnp.float32))
    monkeypatch.setattr(port_cli, "load_subject_model", _in_fp32(port_launch_utils.load_subject_model, torch.float32))
    flags = dict(model=ckpt, data_path=probe, sae_path=sae_dir, selected_sae=HOOK, flash_attention=True,
                 feature_batch=8)
    jax_cli.main(JaxAttributionConfig(save_dir=str(tmp_path / "jax"), **flags))
    written = port_cli.main(AttributionConfig(save_dir=str(tmp_path / "port"), **flags), device="cpu")
    name = "tiny-llava_model_layers_1.safetensors"
    assert os.listdir(tmp_path / "jax") == os.listdir(tmp_path / "port") == [name]
    assert written == str(tmp_path / "port" / name)

    def layout(path):
        header, _ = read_header(path)
        return {k: (v["dtype"], v["shape"]) for k, v in header.items()}

    got_layout, ref_layout = layout(tmp_path / "port" / name), layout(tmp_path / "jax" / name)
    assert got_layout == ref_layout
    ((key, (dtype, shape)),) = got_layout.items()
    assert key == HOOK and dtype == "F32" and shape[0] == 64 * 2  # 64 features x 2 probe rows
    got, ref = load_file(tmp_path / "port" / name)[key].numpy(), load_file(tmp_path / "jax" / name)[key].numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.isfinite(got).all() and got.any()


@pytest.mark.parametrize("flag", [{"int8_matmul": True}, {"load_in_8bit": True}, {"int8_vision": True}],
                         ids=lambda f: next(iter(f)))
def test_cli_attributes_a_quantized_subject(setup_dirs, tmp_path, flag, monkeypatch):
    """The int8 flags reach `load_subject_model`, and the saliency through
    the quantised subject's straight-through products is finite and
    nonzero (`--int8_vision` together with `--load_in_8bit`: it acts only
    on a quantised tower)."""
    from multimodal_sae_tpu_torch.launch.features import attribution_patching as port_cli
    from multimodal_sae_tpu_torch.models.quant import is_quantized

    ckpt, sae_dir, probe = setup_dirs
    flags = dict(flag, load_in_8bit=True) if "int8_vision" in flag else flag
    loaded = []
    load = port_cli.load_subject_model

    def recording(*args, **kw):
        loaded.append((kw, load(*args, **kw)))
        return loaded[-1][1]

    monkeypatch.setattr(port_cli, "load_subject_model", recording)
    path = port_cli.main(AttributionConfig(model=ckpt, data_path=probe, sae_path=sae_dir, selected_sae=HOOK,
                                           save_dir=str(tmp_path / "out"), feature_batch=32, **flags), device="cpu")
    ((kw, (model, _, _)),) = loaded
    assert {k: kw[k] for k in flags} == flags
    assert is_quantized(model.params["language_model"]["layers"][0]["q_proj"])
    maps = load_file(path)[HOOK].numpy()
    assert maps.shape[0] == 64 * 2 and np.isfinite(maps).all() and maps.any()


@pytest.mark.parametrize("flag", [{"tp": 2}, {"dp": 2}, {"remat": True}], ids=lambda f: next(iter(f)))
def test_cli_refuses_options_of_later_slices(setup_dirs, tmp_path, flag, monkeypatch):
    """The options once refused: the subject loader refuses --tp 2 in one
    process and --dp 2 without two cards; --remat (ported in slice 13)
    reaches the subject's text config, and the CLI writes the same file as
    without it, byte for byte (eager attention, the CLI's default)."""
    from multimodal_sae_tpu_torch.launch import utils as port_launch_utils
    from multimodal_sae_tpu_torch.launch.features import attribution_patching as port_cli

    ckpt, sae_dir, probe = setup_dirs
    cfg = AttributionConfig(model=ckpt, data_path=probe, sae_path=sae_dir, selected_sae=HOOK,
                            save_dir=str(tmp_path / "out"), **flag)
    if "remat" in flag:
        loaded = []
        load = _in_fp32(port_launch_utils.load_subject_model, torch.float32)

        def recording(*args, **kw):
            out = load(*args, **kw)
            loaded.append(out[0])
            return out

        monkeypatch.setattr(port_cli, "load_subject_model", recording)
        with_remat = port_cli.main(cfg, device="cpu")
        without = port_cli.main(dataclasses.replace(cfg, remat=False, save_dir=str(tmp_path / "plain")), device="cpu")
        assert [m.cfg.text_config.remat for m in loaded] == [True, False]
        assert os.path.basename(with_remat) == os.path.basename(without)
        with open(with_remat, "rb") as a, open(without, "rb") as b:
            assert a.read() == b.read()
        assert np.abs(load_file(with_remat)[HOOK].numpy()).max() > 0
        return
    with pytest.raises(ValueError, match="world size it divides" if "tp" in flag else "local devices"):
        port_cli.main(cfg, device="cpu")
    assert not (tmp_path / "out").exists()


def test_cli_needs_a_card_unless_told_otherwise(setup_dirs, tmp_path, monkeypatch):
    """With no device named, the CLI resolves to CUDA and raises without
    one, before it loads anything."""
    from multimodal_sae_tpu_torch.launch.features import attribution_patching as port_cli

    ckpt, sae_dir, probe = setup_dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_cli, "load_subject_model", lambda *a, **kw: pytest.fail("the subject loaded"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(AttributionConfig(model=ckpt, data_path=probe, sae_path=sae_dir, selected_sae=HOOK))


def test_cli_turns_tf32_off(setup_dirs, monkeypatch):
    """The CLI sets the precision before it loads the subject."""
    from multimodal_sae_tpu_torch.launch.features import attribution_patching as port_cli

    ckpt, sae_dir, probe = setup_dirs
    seen = []

    class Loaded(Exception):
        pass

    def load(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        raise Loaded

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(port_cli, "load_subject_model", load)
    with pytest.raises(Loaded):
        port_cli.main(AttributionConfig(model=ckpt, data_path=probe, sae_path=sae_dir, selected_sae=HOOK),
                      device="cpu")
    assert seen == [(False, False)]
