"""SAEs named by HuggingFace repository (`org/name`), read from an offline
HuggingFace cache, in the port and in the JAX package: `Sae.load_from_hub`,
`Sae.load_many` (`pattern`, `layers`, `local`), `load_saes`,
`load_single_sae`, the attribution constructor and the text cache CLI.
The SAEs are written by the JAX package; every load gives the same keys in
the same order and every parameter bit for bit, and a failure raises the
same exception type on both sides.  `huggingface_hub` is pointed at a
cache under `tmp_path` with every HTTP session offline
(tests/torch_hub_cache.py)."""

import hashlib
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import multimodal_sae_tpu.interp_utils as jax_utils
from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.features.patching.attribution import Attribution as JaxAttribution
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu_torch import interp_utils
from multimodal_sae_tpu_torch.features.patching.attribution import Attribution
from multimodal_sae_tpu_torch.sae import Sae
from torch_hub_cache import go_offline, write_repo

MULTI, SINGLE, MISSING = "org/multi-sae", "org/single-sae", "org/not-in-the-cache"
ALL = ["embed", "layers.0", "layers.2", "layers.10"]  # natsorted


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """Two repositories written by the JAX package: MULTI with one
    directory a hookpoint (cfg.json one level down), SINGLE with one SAE at
    its root.  Returns (cache dir, MULTI's snapshot directory)."""
    src = tmp_path / "src"
    for i, hook in enumerate(ALL):
        JaxSae(8, JaxSaeConfig(num_latents=32, k=4), key=jax.random.PRNGKey(i)).save_to_disk(src / "multi" / hook)
    JaxSae(8, JaxSaeConfig(num_latents=16, k=2), key=jax.random.PRNGKey(9)).save_to_disk(src / "single")
    cache = tmp_path / "hf_cache"
    snapshot = write_repo(cache, MULTI, src / "multi")
    write_repo(cache, SINGLE, src / "single")
    go_offline(monkeypatch, cache)
    return cache, snapshot


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _assert_same_sae(port: Sae, ref: JaxSae) -> None:
    assert list(port.params) == list(ref.params)
    for name, t in port.params.items():
        np.testing.assert_array_equal(_bits(t), _bits(ref.params[name]), err_msg=name)
    assert (port.d_in, port.cfg.to_dict()) == (ref.d_in, ref.cfg.to_dict())


def _assert_same_saes(port: dict, ref: dict) -> None:
    assert list(port) == list(ref)
    for hook in ref:
        _assert_same_sae(port[hook], ref[hook])


@pytest.mark.parametrize("name,hookpoint", [(MULTI, "layers.2"), (SINGLE, None)], ids=["hookpoint", "root"])
def test_load_from_hub_equals_jax(hub, name, hookpoint):
    port = Sae.load_from_hub(name, hookpoint, device="cpu")
    _assert_same_sae(port, JaxSae.load_from_hub(name, hookpoint))
    enc = Sae.load_from_hub(name, hookpoint, decoder=False, device="cpu")
    assert list(enc.params) == ["W_enc", "b_enc", "b_dec"]


MANY = {"all": ({}, ALL), "pattern": ({"pattern": "layers.*"}, ALL[1:]),
        "layers": ({"layers": ["layers.10", "layers.0"]}, ["layers.0", "layers.10"]),
        "pattern_prefix": ({"pattern": "layers.1*"}, ["layers.10"]), "local": ({"local": True}, ALL)}


@pytest.mark.parametrize("case", list(MANY))
def test_load_many_equals_jax(hub, case):
    """Natsorted keys; `pattern` filters directory names; `local` reads the
    snapshot directory as a path."""
    kw, want = MANY[case]
    name = str(hub[1]) if kw.get("local") else MULTI
    port = Sae.load_many(name, device="cpu", **kw)
    _assert_same_saes(port, JaxSae.load_many(name, **kw))
    assert list(port) == want


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
def test_load_saes_equals_jax(hub, filtered):
    filters = {"layers.10": np.array([1, 2]), "layers.0": np.array([3])} if filtered else None
    ref = jax_utils.load_saes(MULTI, filters)
    _assert_same_saes(interp_utils.load_saes(MULTI, filters, device="cpu", decoder=True), ref)
    # The port's default leaves the decoders on disk (the cache never decodes).
    enc = interp_utils.load_saes(MULTI, filters, device="cpu")
    assert list(enc) == list(ref) and all(list(s.params) == ["W_enc", "b_enc", "b_dec"] for s in enc.values())


def test_load_single_sae_equals_jax(hub):
    _assert_same_sae(interp_utils.load_single_sae(MULTI, "layers.10", device="cpu"),
                     jax_utils.load_single_sae(MULTI, "layers.10"))


class _Tok:
    def __call__(self, text, **kw):
        return {"input_ids": [1] + [2 + ord(c) % 50 for c in text]}

    def convert_tokens_to_ids(self, tok):
        return 2 + ord(tok[0]) % 50


class _Model:
    def prepare_inputs(self, images=None, prompt_ids=None):
        return {"input_ids": np.asarray(prompt_ids, dtype=np.int64)}


@pytest.mark.parametrize("selected", ["layers.2", None], ids=["selected_sae", "all"])
def test_attribution_constructor_equals_jax(hub, tmp_path, selected):
    from PIL import Image

    Image.new("RGB", (8, 8)).save(tmp_path / "x.png")
    data = tmp_path / "probe.json"
    data.write_text(json.dumps([{"prompt": "abq", "answer": "c", "baseline": "d", "image": str(tmp_path / "x.png")}]))
    port = Attribution(_Model(), _Tok(), MULTI, str(data), selected_sae=selected, device="cpu")
    ref = JaxAttribution(_Model(), _Tok(), MULTI, str(data), selected_sae=selected)
    _assert_same_saes(port.sae_dict, ref.sae_dict)
    assert list(port.sae_dict) == (["layers.2"] if selected else ALL)


CALLS = {
    "load_from_hub": lambda pkg: pkg["Sae"].load_from_hub(MISSING, "layers.0", **pkg["kw"]),
    "load_many": lambda pkg: pkg["Sae"].load_many(MISSING, **pkg["kw"]),
    "load_saes": lambda pkg: pkg["utils"].load_saes(MISSING, **pkg["kw"]),
    "load_single_sae": lambda pkg: pkg["utils"].load_single_sae(MISSING, "layers.0", **pkg["kw"]),
    "no_cfg_at_root": lambda pkg: pkg["Sae"].load_from_hub(MULTI, **pkg["kw"]),
}
PACKAGES = ({"Sae": Sae, "utils": interp_utils, "kw": {"device": "cpu"}}, {"Sae": JaxSae, "utils": jax_utils, "kw": {}})


def _raised(call) -> type:
    try:
        call()
    except Exception as e:  # the type is what is compared
        return type(e)
    raise AssertionError("no exception")


@pytest.mark.parametrize("without_hub", [False, True], ids=["missing_repo", "no_huggingface_hub"])
@pytest.mark.parametrize("call", list(CALLS))
def test_failures_raise_the_same_type(hub, monkeypatch, call, without_hub):
    """A repository missing from the offline cache raises huggingface_hub's
    `LocalEntryNotFoundError`, a multi-hookpoint repository loaded without
    a hookpoint `FileNotFoundError`, and every hub name `FileNotFoundError`
    when `huggingface_hub` cannot be imported: the same type on both sides."""
    if without_hub:
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    port, ref = (_raised(lambda pkg=pkg: CALLS[call](pkg)) for pkg in PACKAGES)
    assert port is ref
    if without_hub:
        assert ref is FileNotFoundError
    elif call != "no_cfg_at_root":
        from huggingface_hub.errors import LocalEntryNotFoundError

        assert issubclass(ref, LocalEntryNotFoundError)


def test_the_same_allow_patterns_reach_snapshot_download(hub, monkeypatch):
    """The mirror of tests/test_sae.py::test_load_many_hub_multi_hookpoint:
    each loader asks `snapshot_download` for the same name and filter in
    both packages."""
    import huggingface_hub

    seen = []

    def fake_snapshot_download(name, allow_patterns=None, **kw):
        seen.append((name, allow_patterns, kw))
        return str(hub[1])

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    asked = []
    for pkg in PACKAGES:
        seen.clear()
        pkg["Sae"].load_many(MULTI, pattern="layers.*", **pkg["kw"])
        pkg["Sae"].load_many(MULTI, **pkg["kw"])
        pkg["Sae"].load_from_hub(MULTI, "layers.2", **pkg["kw"])
        pkg["utils"].load_saes(MULTI, {"layers.0": np.array([0])}, **pkg["kw"])
        pkg["utils"].load_single_sae(MULTI, "embed", **pkg["kw"])
        asked.append(list(seen))
    assert asked[0] == asked[1] == [(MULTI, "layers.*/*", {}), (MULTI, None, {}), (MULTI, "layers.2/*", {}),
                                    (MULTI, "layers.0/*", {}), (MULTI, "embed/*", {})]


def _digests(d) -> dict:
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest() for f in sorted(os.listdir(d))}


def test_text_cache_cli_on_a_hub_name(hub, tmp_path):
    """The text cache CLI (as tests/test_torch_cache.py drives it on a
    synthetic subject) with `--sae_path` a hub name writes the splits the
    same run on the local directory writes, byte for byte."""
    from datasets import Dataset

    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch.cache import cache as port_cli

    ids = np.random.default_rng(6).integers(0, 32, size=(6, 12))
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(tmp_path / "ds"))
    filters = tmp_path / "filters.json"
    filters.write_text(json.dumps({"layers.2": [0, 5, 9]}))
    for run, sae_path in (("hub", MULTI), ("local", str(hub[1]))):
        port_cli.main(CacheConfig(model="synthetic://8,3,32", dataset=str(tmp_path / "ds"), sae_path=sae_path,
                                  filters_path=str(filters), batch_size=2, ctx_len=12, n_splits=4,
                                  save_dir=str(tmp_path / run)), device="cpu")
    got = _digests(tmp_path / "hub" / "layers.2")
    assert len(got) == 8 and got == _digests(tmp_path / "local" / "layers.2")
