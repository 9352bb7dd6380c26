"""The in-process `--dp` replicas (parallel/data_parallel.py) on the CPU,
with the replicas placed on ["cpu", "cpu"] (`shard_subject_model_dp(...,
devices=)`; a CLI's call is given them through a patched default), against
the one-device run and the JAX package.

* The cache CLI at `--dp 2`: its splits and sidecars equal byte for byte
  the JAX CLI's at `--dp 2` and a one-device run at 2 x batch_size (JAX
  launch/cache/cache.py:60-64), captures on the drivers' grid with the grid
  SAE (tests/torch_tp_tiny.py), so the encoder is exact in both packages.
* The image cache: a geometry group that the replicas do not divide is
  padded by repeating its last image (JAX models/llava_next.py:569-574),
  and the captures equal the one-device run's within CAPTURE_TOL; the
  image CLI at `--dp 2` equals a one-device run at 2 x batch_size.
* Attribution's feature chunk, split over 4 replicas, against the
  unsharded fast path (JAX tests/test_launch_integration.py:530-577); the
  steering generate batch (greedy, clamped, and sampled: the draws are the
  one-device run's) and the controller's top-up of a ragged chunk (JAX
  tests/test_parallel.py:231-395).
* Training capture at `--dp 2` against the one-device trainer (JAX
  tests/test_launch_integration.py:579-612).
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_mp_drivers.common import in_fp32, on_grid
from torch_tp_tiny import write_checkpoint, write_grid_sae

CAPTURE_TOL = dict(rtol=1e-5, atol=1e-5)
ATTRIBUTION_TOL = dict(rtol=1e-5, atol=1e-7)  # JAX test_launch_integration.py:576


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("dp_llama"))


@pytest.fixture(scope="module")
def subject(ckpt):
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model

    return load_subject_model(ckpt, dtype=torch.float32, device="cpu")[0]


def _replicated(ckpt, devices):
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.parallel import shard_subject_model_dp

    model = load_subject_model(ckpt, dtype=torch.float32, device="cpu")[0]
    return shard_subject_model_dp(model, len(devices), devices=devices)[0]


@pytest.fixture
def cpu_replicas(monkeypatch):
    """A CLI's `--dp N` places its N replicas on the CPU; returns the
    replica counts of every row split (`map_rows`) in the models
    (`.subject`) and in the cache's encode (`.encode`)."""
    from multimodal_sae_tpu_torch import parallel
    from multimodal_sae_tpu_torch.features import cache
    from multimodal_sae_tpu_torch.models import llama, llava_next
    from multimodal_sae_tpu_torch.parallel import data_parallel

    monkeypatch.setattr(parallel, "shard_subject_model_dp",
                        lambda model, dp: data_parallel.shard_subject_model_dp(model, dp, devices=["cpu"] * dp))
    splits = SimpleNamespace(subject=[], encode=[])

    def counted(into):
        def map_rows(model, fn, *rows):
            into.append(len(data_parallel.replicas_of(model)))
            return data_parallel.map_rows(model, fn, *rows)
        return map_rows

    for module in (llama, llava_next):
        monkeypatch.setattr(module, "map_rows", counted(splits.subject))
    monkeypatch.setattr(cache, "map_rows", counted(splits.encode))
    return splits


def _files(d):
    files = sorted(os.listdir(d))
    assert files and not any(f.startswith("Rank") for f in files), files
    return {f: (d / f).read_bytes() for f in files}


class _GridSubject:
    """The JAX CLI's subject stood in for by the port's unsharded model,
    its captures rounded onto the grid and handed over as JAX arrays."""

    def __init__(self, model):
        self.model = model

    def hookpoint_names(self):
        return self.model.hookpoint_names()

    def capture(self, batch, hookpoints):
        return {h: jnp.asarray(on_grid(x).numpy()) for h, x in self.model.capture(batch, hookpoints).items()}


def test_cache_cli_dp2_equals_the_jax_cli_and_one_device_at_twice_the_batch(ckpt, subject, cpu_replicas, tmp_path,
                                                                              monkeypatch):
    from datasets import Dataset

    from multimodal_sae_tpu.config import CacheConfig as JaxCacheConfig
    from multimodal_sae_tpu.launch.cache import cache as jax_cli
    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch import utils as launch_utils
    from multimodal_sae_tpu_torch.launch.cache import cache as cache_cli
    from multimodal_sae_tpu_torch.models.llama import LlamaModel

    ids = np.random.default_rng(1).integers(1, 255, size=(10, 8))  # 2 steps of 4 rows and a dropped tail
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(tmp_path / "ds"))
    sae_dir = write_grid_sae(tmp_path / "saes", "layers.1", 64)
    capture = LlamaModel.capture
    monkeypatch.setattr(LlamaModel, "capture",
                        lambda self, batch, hooks: {h: on_grid(x) for h, x in capture(self, batch, hooks).items()})
    monkeypatch.setattr(launch_utils, "load_subject_model", in_fp32(launch_utils.load_subject_model))
    common = dict(model=ckpt, dataset=str(tmp_path / "ds"), sae_path=sae_dir, ctx_len=8, n_splits=2)
    cache_cli.main(CacheConfig(**common, save_dir=str(tmp_path / "dp"), batch_size=2, dp=2), device="cpu")
    assert cpu_replicas.subject == cpu_replicas.encode == [2, 2]  # one split of 4 rows a step
    cache_cli.main(CacheConfig(**common, save_dir=str(tmp_path / "one"), batch_size=4), device="cpu")
    monkeypatch.setattr(jax_cli, "load_subject_or_synthetic", lambda cfg: (_GridSubject(subject), None, None))
    jax_cli.main(JaxCacheConfig(**common, save_dir=str(tmp_path / "jax"), batch_size=2, dp=2))
    dp, one, jax_dp = (_files(tmp_path / name / "layers.1") for name in ("dp", "one", "jax"))
    assert len(dp) == 4 and dp == one == jax_dp


def test_image_capture_pads_an_undivided_geometry_group(tmp_path, monkeypatch):
    from torch_llava_tiny import IMG_TOKEN, images, write_checkpoint as write_llava

    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.parallel import data_parallel, shard_subject_model_dp

    (tmp_path / "llava").mkdir()
    ckpt = write_llava(tmp_path / "llava")
    model = load_subject_model(ckpt, dtype=torch.float32, device="cpu", truncate_layers=2)[0]
    a, b = images([(50, 70), (90, 40)], seed=3)
    batch = model.prepare_inputs(images=[a, a, b], prompt_ids=[[5, IMG_TOKEN, 6]] * 3)
    hook = "model.layers.1"
    want = model.capture(batch, [hook])[hook]
    shard_subject_model_dp(model, 2, devices=["cpu", "cpu"])
    rows = []
    place = data_parallel.place_rows_padded
    monkeypatch.setattr(data_parallel, "place_rows_padded", lambda x, r: (rows.append(x.shape[0]), place(x, r))[1])
    got = model.capture(batch, [hook])[hook]
    # The tower's groups: (50, 70) once (rows that share an image share its
    # tower call) and (90, 40) once, each padded to 2; then the language
    # model's 3 rows, padded to 4, and their mask.
    assert rows == [1, 1, 3, 3]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CAPTURE_TOL)


def test_image_cache_cli_dp2_equals_one_device_at_twice_the_batch(cpu_replicas, tmp_path, monkeypatch):
    from datasets import Dataset

    from torch_llava_tiny import images, write_checkpoint as write_llava

    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch.cache import cache_image as cli
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextModel

    (tmp_path / "llava").mkdir()
    ckpt = write_llava(tmp_path / "llava", seed=5)
    Dataset.from_dict({"image": images([(50, 70), (90, 40), (64, 64), (50, 70)], seed=6)}).save_to_disk(
        str(tmp_path / "ds"))
    sae_dir = write_grid_sae(tmp_path / "saes", "model.layers.1", 64)
    monkeypatch.setattr(cli, "load_subject_model", in_fp32(cli.load_subject_model))
    capture = LlavaNextModel.capture
    monkeypatch.setattr(LlavaNextModel, "capture",
                        lambda self, *a, **kw: {h: on_grid(x) for h, x in capture(self, *a, **kw).items()})
    common = dict(model=ckpt, dataset=str(tmp_path / "ds"), sae_path=sae_dir, ctx_len=64, n_splits=2,
                  flash_attention=True, truncate_layers=2)
    cli.main(CacheConfig(**common, save_dir=str(tmp_path / "dp"), batch_size=2, dp=2), device="cpu")
    assert cpu_replicas.subject and set(cpu_replicas.subject) == {2}
    assert cpu_replicas.encode == [2]  # one step; each replica's rows encoded by its copy of the SAE
    cli.main(CacheConfig(**common, save_dir=str(tmp_path / "one"), batch_size=4), device="cpu")
    assert _files(tmp_path / "dp" / "model.layers.1") == _files(tmp_path / "one" / "model.layers.1")


def test_replicate_saes_gives_each_replica_device_a_copy(ckpt):
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.parallel import replicate_saes
    from multimodal_sae_tpu_torch.sae import Sae

    model = _replicated(ckpt, ["cpu", "meta", "cpu", "meta"])
    sae = Sae(model.cfg.hidden_size, SaeConfig(num_latents=32, k=4), seed=0, device="cpu")
    replicate_saes(model, [sae])
    first, second = sae.dp_replicas[0], sae.dp_replicas[1]
    assert first is sae and sae.dp_replicas == [sae, second, sae, second]
    assert second is not sae and second.device == torch.device("meta")
    assert {k: (v.shape, v.device.type) for k, v in second.params.items()} == {
        k: (v.shape, "meta") for k, v in sae.params.items()}


def test_attribution_feature_chunk_split_over_replicas_matches_unsharded(ckpt, subject):
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.patching.attribution import fast_attribution_maps
    from multimodal_sae_tpu_torch.features.patching.utils import get_logit_diff
    from multimodal_sae_tpu_torch.sae import Sae

    sae = Sae(64, SaeConfig(num_latents=128, k=8), seed=1, device="cpu")
    batch = {"input_ids": np.array([[1, 5, 9, 13, 2, 40, 7]])}
    metric = functools.partial(get_logit_diff, answer_token_indices=torch.tensor([[3, 7]]))
    indices = np.arange(10)  # ragged against both feature_batch 2 and the rounded 4
    ref = fast_attribution_maps(subject, "layers.1", sae, batch, metric, indices, feature_batch=2, progress=False)
    dp_model = _replicated(ckpt, ["cpu"] * 4)
    out = fast_attribution_maps(dp_model, "layers.1", sae, batch, metric, indices, feature_batch=2, progress=False)
    assert len(out["layers.1"]) == len(ref["layers.1"]) == 10
    assert max(np.abs(a).max() for a in ref["layers.1"]) > 1e-3
    for a, b in zip(ref["layers.1"], out["layers.1"]):
        np.testing.assert_allclose(b, a, **ATTRIBUTION_TOL)


@pytest.mark.parametrize("mode", ["greedy_clamped", "sampled"])
def test_generate_batch_split_over_replicas_matches_unsharded(ckpt, subject, mode):
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.steering import clamp_features_max_batched
    from multimodal_sae_tpu_torch.sae import Sae

    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(1, 255, size=(4, 6)), "attention_mask": np.ones((4, 6), np.int64)}
    batch["attention_mask"][1, :2] = 0
    kw = dict(max_new_tokens=8, eos_token_id=None)
    if mode == "sampled":
        kw.update(do_sample=True, temperature=1.0, top_p=0.9, seed=3)
    else:
        sae = Sae(64, SaeConfig(num_latents=128, k=8), seed=2, device="cpu")
        kw["interventions"] = {"layers.1": clamp_features_max_batched(sae, [3, 40, 77, 100], k=5.0)}
    want = subject.generate(batch, **kw)
    got = _replicated(ckpt, ["cpu", "cpu"]).generate(batch, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_steering_tops_a_ragged_chunk_up_to_the_replicas(ckpt, subject):
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.steering import SteeringController
    from multimodal_sae_tpu_torch.sae import Sae

    class Chat:
        eos_token_id = None

        def apply_chat_template(self, conversation, **kw):
            return conversation[0]["content"][0]["text"]

        def __call__(self, text, **kw):
            return {"input_ids": [int(t) for t in text.split()]}

        def batch_decode(self, arr, skip_special_tokens=True):
            return [" ".join(str(int(t)) for t in row) for row in np.asarray(arr)]

    sae = Sae(64, SaeConfig(num_latents=128, k=8), seed=2, device="cpu")
    dp_model = _replicated(ckpt, ["cpu", "cpu"])
    rows = []
    generate = dp_model.generate
    dp_model.generate = lambda batch, **kw: (rows.append(len(batch["input_ids"])), generate(batch, **kw))[1]

    def run(model):
        return SteeringController(sae, "layers.1", [3, 40, 77, 100, 5], model, Chat(), "1 7 22 9 41", k=5.0,
                                  max_new_tokens=6, feature_batch_size=3).run()

    want, got = run(subject), run(dp_model)
    assert rows == [1, 4, 2]  # the baseline, 3 features topped up to 4, then 2
    assert got == want and len(got) == 5


def test_training_capture_over_replicas_matches_one_device(ckpt, subject):
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.train import SaeTrainer

    rng = np.random.default_rng(3)
    rows = [{"input_ids": rng.integers(0, 255, size=(16,))} for _ in range(8)]
    batch = {"input_ids": np.stack([r["input_ids"] for r in rows[:4]])}

    def train(model):
        cfg = TrainConfig(sae=SaeConfig(expansion_factor=4, k=4), batch_size=4, lr=1e-3, log_to_wandb=False,
                          hookpoints=["layers.1"])
        trainer = SaeTrainer(cfg, rows, model, device="cpu")
        for _ in range(2):
            trainer.step(batch)
        return trainer.saes["layers.1"].params["W_enc"].detach().numpy()

    np.testing.assert_allclose(train(_replicated(ckpt, ["cpu", "cpu"])), train(subject), rtol=2e-4, atol=1e-5)


def test_dp_beyond_the_local_cards_is_refused(subject):
    import copy

    from multimodal_sae_tpu_torch.parallel import shard_subject_model_dp

    with pytest.raises(ValueError, match=r"--dp 2 > local devices"):
        shard_subject_model_dp(copy.copy(subject), 2)
