"""SAE training on multimodal data in the port against the JAX package:
`process_mm_data`, `DataCollatorForImage`, `SaeTrainer` with a collator on
the tiny LLaVA of tests/torch_llava_tiny.py (numpy-drawn fp32 weights,
carried by `convert.py`), and `python -m multimodal_sae_tpu_torch ...
--mm_data` on a tiny checkpoint directory.

* `process_mm_data`'s ids and columns, and the collator's ids, masks and
  images: exactly equal.
* The trainers over 4 batches of 2 rows (two anyres geometries, so every
  batch is ragged and right-padded by the subject): the dead-feature
  counters, the step counters and the windows' fired masks exactly equal;
  the parameters within 1e-2 * lr and the fvu and AuxK metrics within
  rtol 1e-5, the bounds of tests/test_torch_trainer.py (fp32 noise: the
  first Adam step is about lr * sign(g)).
* The CLI: the JAX CLI cannot train on a saved dataset whose `image` column
  is an image feature (its numpy formatting turns the images into arrays,
  which its preprocessing cannot read); the port's keeps the images and
  writes `sae.safetensors` and `cfg.json` with the JAX trainer's keys,
  shapes and dtypes."""

import functools
import json
from collections import defaultdict

import numpy as np
import pytest

import jax
import torch

from multimodal_sae_tpu.config import SaeConfig as JaxSaeConfig
from multimodal_sae_tpu.config import TrainConfig as JaxTrainConfig
from multimodal_sae_tpu.parallel import get_mesh
from multimodal_sae_tpu.sae import Sae as JaxSae
from multimodal_sae_tpu.train import SaeTrainer as JaxTrainer
from multimodal_sae_tpu.train import process_mm_data as jax_process_mm_data
from multimodal_sae_tpu.train.collator import DataCollatorForImage as JaxCollator
from multimodal_sae_tpu.train.trainer import _iter_batches as jax_iter_batches
from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
from multimodal_sae_tpu_torch.convert import sae_params_from_jax
from multimodal_sae_tpu_torch.train import DataCollatorForImage, SaeTrainer, process_mm_data
from multimodal_sae_tpu_torch.train.trainer import _iter_batches
from multimodal_sae_tpu_torch.utils.safetensors_io import read_header

from torch_llava_tiny import BOS, EOS, IMG_TOKEN, images, models, write_checkpoint

HOOK = "model.layers.1"
LR = 1e-3
PARAM_ATOL = 1e-2 * LR
RTOL = 1e-5
SIZES = [(50, 70), (90, 40)]  # two anyres geometries: every batch is ragged


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("torch_llava_mm_ckpt"), seed=5)


def _conversations(n):
    return [[{"from": "human", "value": f"<image> {i} {i + 1}"}, {"from": "gpt", "value": f"{i + 2} 7 9"},
             {"from": "narrator", "value": "3", "lang": "en"}] for i in range(n)]


def test_process_mm_data_matches_jax(ckpt):
    from datasets import Dataset
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(ckpt)
    ds = Dataset.from_dict({"image": images(SIZES * 2, seed=1), "conversations": _conversations(4), "id": list("abcd")})
    got, ref = process_mm_data(ds, tok), jax_process_mm_data(ds, tok)
    assert got.column_names == ref.column_names and "image" in got.column_names and "id" not in got.column_names
    for i in range(len(ds)):
        np.testing.assert_array_equal(got[i]["input_ids"], ref[i]["input_ids"])
        np.testing.assert_array_equal(got[i]["image"], ref[i]["image"])
    ids = np.asarray(got[0]["input_ids"]).reshape(-1)
    assert ids[0] == BOS and IMG_TOKEN in ids and (ids == EOS).sum() == 3


class _Tok:
    def __init__(self, padding_side, pad_token_id, eos_token_id=2, model_max_length=100):
        self.padding_side, self.pad_token_id = padding_side, pad_token_id
        self.eos_token_id, self.model_max_length = eos_token_id, model_max_length


ROWS = [np.array([1, 7, 2, 9, 2]), np.array([1, 5]), np.array([1, 3, IMG_TOKEN, 4])]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("pad", [None, 0], ids=["padless", "pad0"])
@pytest.mark.parametrize("max_length", [100, 3], ids=["whole", "truncated"])
def test_collator_matches_jax(side, pad, max_length):
    imgs = images(SIZES + [(40, 40)], seed=2)
    instances = [{"input_ids": r, "image": im} for r, im in zip(ROWS, imgs)]
    instances[1]["image"] = [imgs[1]]  # a one-image list, as some datasets hold it
    tok = _Tok(side, pad, model_max_length=max_length)
    got, ref = DataCollatorForImage(tok)(instances), JaxCollator(tok)(instances)
    assert got.keys() == ref.keys() == {"images", "input_ids", "attention_mask"}
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])
    for g, r in zip(got["images"], ref["images"]):
        assert g.mode == "RGB" and np.array_equal(np.asarray(g), np.asarray(r))
    lengths = [min(len(r), max_length) for r in ROWS]
    assert got["attention_mask"].sum(1).tolist() == lengths


def test_collator_padless_tokenizer_keeps_content_eos():
    """The JAX package's case (tests/test_mm_training.py): a pad-less
    tokenizer pads with EOS, and the real EOS tokens keep attention 1."""
    tok = _Tok("left", None)
    rows = [{"input_ids": np.array([1, 7, 2, 9, 2]), "image": None}, {"input_ids": np.array([1, 5]), "image": None}]
    got, ref = DataCollatorForImage(tok)(rows), JaxCollator(tok)(rows)
    np.testing.assert_array_equal(got["attention_mask"], [[1, 1, 1, 1, 1], [0, 0, 0, 1, 1]])
    np.testing.assert_array_equal(got["input_ids"][1], [2, 2, 2, 1, 5])
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert got["images"] == ref["images"] == [None, None]


def _rows(n=8, seed=0):
    """process_mm_data-like rows: ids with one un-expanded `<image>` and a
    PIL image, of two geometries and several lengths."""
    rng = np.random.default_rng(seed)
    imgs = images(SIZES * (n // 2), seed=seed)
    return [{"input_ids": np.concatenate([[BOS, IMG_TOKEN], rng.integers(2, 200, size=3 + i % 3)]), "image": im}
            for i, im in enumerate(imgs)]


def _cfg_kwargs():
    return dict(batch_size=2, grad_acc_steps=2, micro_acc_steps=1, lr=LR, lr_warmup_steps=0, auxk_alpha=1 / 32,
                dead_feature_threshold=20, log_to_wandb=False, save_every=10_000, hookpoints=[HOOK], mm_data=True)


def test_trainer_with_collator_matches_jax():
    """4 ragged batches of 2 rows (2 optimizer steps), b_dec from the first
    batch, AuxK once a latent goes dead."""
    jmodel, model = models(seed=0)
    ds = _rows()
    tok = _Tok("right", 0)
    jt = JaxTrainer(JaxTrainConfig(sae=JaxSaeConfig(expansion_factor=1, k=4), **_cfg_kwargs()), ds, jmodel,
                    mesh=get_mesh(("data",), devices=jax.devices()[:1]), collator=JaxCollator(tok))
    tt = SaeTrainer(TrainConfig(sae=SaeConfig(expansion_factor=1, k=4), **_cfg_kwargs()), ds, model, device="cpu",
                    collator=DataCollatorForImage(tok))
    params = sae_params_from_jax({k: np.asarray(v) for k, v in jt.saes[HOOK].params.items()}, device="cpu")
    with torch.no_grad():
        for name, t in params.items():
            tt.saes[HOOK].params[name].copy_(t)
    batches = list(_iter_batches(ds, 2, collator=tt.collator))
    jbatches = list(jax_iter_batches(ds, 2, collator=jt.collator))
    assert len(batches) == len(jbatches) == 4
    dead_seen = 0
    for i, (b, jb) in enumerate(zip(batches, jbatches)):
        np.testing.assert_array_equal(b["input_ids"], jb["input_ids"])
        had_dead = bool((tt.num_tokens_since_fired[HOOK] > 20).any())
        jm, tm = {HOOK: defaultdict(float)}, {HOOK: defaultdict(float)}
        jt.step(jb, jm)
        tt.step(b, tm)
        for key in ("fvu", "auxk"):
            np.testing.assert_allclose(tm[HOOK][key], jm[HOOK][key], rtol=RTOL, atol=1e-7)
        np.testing.assert_array_equal(tt.num_tokens_since_fired[HOOK], jt.num_tokens_since_fired[HOOK])
        if i % 2 == 0:
            np.testing.assert_array_equal(tt._fired_dev[HOOK].numpy(), np.asarray(jt._fired_dev[HOOK]))
        assert (tt.global_step, tt.opt_step) == (jt.global_step, jt.opt_step)
        for name, p in jt.saes[HOOK].params.items():
            np.testing.assert_allclose(tt.saes[HOOK].params[name].detach().numpy(), np.asarray(p), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"batch {i}, {name}")
        assert (tm[HOOK]["auxk"] > 0) == had_dead
        dead_seen += had_dead
    assert dead_seen > 0, "no latent went dead: AuxK never ran"
    # The counters count the collated, un-expanded ids: an image is one token.
    assert tt.num_tokens_since_fired[HOOK].max() <= sum(b["input_ids"].size for b in batches)


def test_trainer_trains_every_captured_row(monkeypatch):
    """A ragged batch trains on B x S captured rows, pad rows included, and
    counts the collated ids toward the dead-feature threshold."""
    import multimodal_sae_tpu_torch.train.trainer as T

    _, model = models(seed=0)
    ds = _rows(4)
    tt = SaeTrainer(TrainConfig(sae=SaeConfig(expansion_factor=1, k=4), **_cfg_kwargs()), ds, model, device="cpu",
                    collator=DataCollatorForImage(_Tok("left", None)))
    batch = next(_iter_batches(ds, 2, collator=tt.collator))
    prepared = model._maybe_prepare(batch)
    assert not np.asarray(prepared["attention_mask"]).all()  # the subject right-pads the ragged rows
    seen = []
    real_accumulate = T.accumulate

    def spy(params, hiddens, *a, **kw):
        seen.append(hiddens.shape[0])
        return real_accumulate(params, hiddens, *a, **kw)

    monkeypatch.setattr(T, "accumulate", spy)
    tt.step(batch)
    assert seen == [prepared["input_ids"].size]
    assert tt._num_tokens_in_step == batch["input_ids"].size


def _ds_dir(tmp_path, n=8):
    from datasets import Dataset

    path = tmp_path / "mm_ds"
    Dataset.from_dict({"image": images(SIZES * (n // 2), seed=4), "conversations": _conversations(n)}) \
        .save_to_disk(str(path))
    return str(path)


def _cli_argv(ckpt, ds, run):
    return [ckpt, ds, "--mm_data", "--batch_size", "2", "--grad_acc_steps", "2", "--hookpoints", HOOK,
            "--expansion_factor", "1", "--k", "4", "--lr", str(LR), "--lr_warmup_steps", "0", "--save_every", "1000",
            "--no-log-to-wandb", "--run_name", run]


def test_cli_trains_on_multimodal_data(ckpt, tmp_path, monkeypatch):
    from multimodal_sae_tpu import __main__ as jax_main
    from multimodal_sae_tpu_torch import __main__ as port_main
    from multimodal_sae_tpu_torch.launch import utils as port_launch_utils

    ds = _ds_dir(tmp_path)
    monkeypatch.setattr(port_launch_utils, "load_subject_model",
                        functools.partial(port_launch_utils.load_subject_model, dtype=torch.float32))
    trainer = port_main.run(_cli_argv(ckpt, ds, str(tmp_path / "port")), device="cpu")
    assert trainer.global_step == 4 and trainer.opt_step == 2
    sae_dir = tmp_path / "port" / HOOK
    assert sorted(p.name for p in sae_dir.iterdir()) == ["cfg.json", "sae.safetensors"]
    # The JAX trainer's SAE of the same flags, as its checkpoint writes it.
    JaxSae(64, JaxSaeConfig(expansion_factor=1, k=4), key=jax.random.PRNGKey(0)).save_to_disk(tmp_path / "jax_sae")

    def layout(d):
        header, _ = read_header(d / "sae.safetensors")
        return {k: (v["dtype"], v["shape"]) for k, v in header.items()}, json.loads((d / "cfg.json").read_text())

    assert layout(sae_dir) == layout(tmp_path / "jax_sae")
    assert json.loads((tmp_path / "port" / "config.json").read_text())["mm_data"] is True
    assert all(np.isfinite(p.detach().numpy()).all() for p in trainer.saes[HOOK].params.values())

    # The JAX CLI on the same directory: its numpy formatting decodes the
    # image column into arrays, which its preprocessing cannot read.
    monkeypatch.setattr("sys.argv", ["multimodal_sae_tpu", *_cli_argv(ckpt, ds, str(tmp_path / "jax"))])
    with pytest.raises(AttributeError, match="convert"):
        jax_main.run()


def test_cli_refuses_mm_data_on_a_synthetic_subject(tmp_path):
    from multimodal_sae_tpu_torch.__main__ import run

    data = tmp_path / "ids.bin"
    np.random.default_rng(0).integers(0, 64, size=8 * 8).astype(np.uint16).tofile(data)
    with pytest.raises(ValueError, match="synthetic"):
        run(["synthetic://16,2,64", str(data), "--mm_data", "--ctx_len", "8", "--batch_size", "2",
             "--hookpoints", "layers.1", "--run_name", str(tmp_path / "run")], device="cpu")
    assert not (tmp_path / "run").exists()
