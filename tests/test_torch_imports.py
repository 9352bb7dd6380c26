"""The PyTorch port stands alone: no file of it, nor chip_smoke.py, imports
jax or the JAX package; importing every module of it in a fresh interpreter
leaves both unloaded; the loader's modules import without PIL or
safetensors, as on the card's machine; its entry points refuse to run
without a CUDA device unless the caller names one; chip_smoke.py fails
without a card, and alone in a directory, and prints no result."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodal_sae_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "multimodal_sae_tpu")
ATTRIBUTION_MODULES = (
    "multimodal_sae_tpu_torch.ops.gather_rows",
    "multimodal_sae_tpu_torch.ops.sparse_decode",
    "multimodal_sae_tpu_torch.features.patching",
    "multimodal_sae_tpu_torch.features.patching.attribution",
    "multimodal_sae_tpu_torch.features.patching.utils",
)
IMAGE_MODULES = (
    "multimodal_sae_tpu_torch.launch.cache.cache_image",
    "multimodal_sae_tpu_torch.models.clip_vit",
    "multimodal_sae_tpu_torch.models.llava_next",
)
LOADER_MODULES = (
    "multimodal_sae_tpu_torch.features.constructors",
    "multimodal_sae_tpu_torch.features.dim_reduce",
    "multimodal_sae_tpu_torch.features.dim_reduce.dim_reducer",
    "multimodal_sae_tpu_torch.features.dim_reduce.pca",
    "multimodal_sae_tpu_torch.features.dim_reduce.umap",
    "multimodal_sae_tpu_torch.features.features",
    "multimodal_sae_tpu_torch.features.loader",
    "multimodal_sae_tpu_torch.features.samplers",
    "multimodal_sae_tpu_torch.features.split_index",
    "multimodal_sae_tpu_torch.features.stats",
)
TRAIN_MODULES = (
    "multimodal_sae_tpu_torch.__main__",
    "multimodal_sae_tpu_torch.ops.adam",
    "multimodal_sae_tpu_torch.ops.adam8bit",
    "multimodal_sae_tpu_torch.ops.geometric_median",
    "multimodal_sae_tpu_torch.train.data",
    "multimodal_sae_tpu_torch.train.trainer",
)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_imports_in_the_port_or_chip_smoke():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_every_module_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodal_sae_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"assert set({ATTRIBUTION_MODULES + IMAGE_MODULES + LOADER_MODULES + TRAIN_MODULES!r}) <= set(names)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert len(names) > 20 and not bad, (len(names), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert r.returncode == 0, r.stderr[-2000:]


def test_loader_modules_import_without_pil_or_safetensors():
    """The card's machine has neither: the loader, constructors, split
    index and stats import without them, and a split is written and read."""
    code = (
        "import sys\n"
        "for name in ('PIL', 'safetensors'): sys.modules[name] = None\n"
        "import numpy as np, os, tempfile\n"
        "from multimodal_sae_tpu_torch.features import constructors, loader, split_index, stats, FeatureDataset\n"
        "from multimodal_sae_tpu_torch.features.dim_reduce import PcaReducer\n"
        "from multimodal_sae_tpu_torch.utils.safetensors_io import save_file\n"
        "d = tempfile.mkdtemp()\n"
        "os.mkdir(os.path.join(d, 'm'))\n"
        "loc = np.array([[0, 1, 2], [1, 0, 2], [1, 1, 3]], np.int64)\n"
        "save_file({'locations': loc, 'activations': np.ones(3, np.float32)}, os.path.join(d, 'm', '0_3.safetensors'))\n"
        "assert split_index.ensure_index(d) == 1\n"
        "from multimodal_sae_tpu_torch.config import FeatureConfig\n"
        "ds = FeatureDataset(d, FeatureConfig(width=4, n_splits=1, min_examples=1))\n"
        "assert [r.feature.feature_index for r in ds.load(collate=True)] == [2, 3]\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('PIL', 'safetensors') and sys.modules[m]]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from multimodal_sae_tpu_torch.__main__ import run
    from multimodal_sae_tpu_torch.config import CacheConfig, SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.features.patching import Attribution
    from multimodal_sae_tpu_torch.features import stats
    from multimodal_sae_tpu_torch.features.dim_reduce import PcaReducer
    from multimodal_sae_tpu_torch.features.features import Feature, FeatureRecord
    from multimodal_sae_tpu_torch.interp_utils import load_saes, load_single_sae
    from multimodal_sae_tpu_torch.launch.cache import cache as cli
    from multimodal_sae_tpu_torch.launch.cache import cache_image as image_cli
    from multimodal_sae_tpu_torch.launch.utils import load_subject_model
    from multimodal_sae_tpu_torch.models import LlamaConfig, LlamaModel, LlavaNextConfig, LlavaNextModel, SyntheticActivationSource
    from multimodal_sae_tpu_torch.models.clip_vit import ClipVisionConfig
    from multimodal_sae_tpu_torch.models.llava_next import load_llava_next
    from multimodal_sae_tpu_torch.sae import Sae
    from multimodal_sae_tpu_torch.train import SaeTrainer

    tiny = LlamaConfig(vocab_size=8, hidden_size=8, intermediate_size=8, num_hidden_layers=1,
                       num_attention_heads=2, num_key_value_heads=1)
    Sae(4, SaeConfig(expansion_factor=2, k=2), device="cpu").save_to_disk(tmp_path / "layers.0")
    calls = [
        lambda: Sae(4, SaeConfig(expansion_factor=2, k=2)),
        lambda: Sae.load_from_disk(tmp_path / "layers.0"),
        lambda: load_saes(str(tmp_path)),
        lambda: LlamaModel.random(tiny),
        lambda: LlavaNextModel.random(LlavaNextConfig(text_config=tiny, vision_config=ClipVisionConfig(
            hidden_size=8, intermediate_size=8, num_hidden_layers=1, num_attention_heads=2, image_size=4, patch_size=2))),
        lambda: load_llava_next(str(tmp_path)),
        lambda: load_subject_model(str(tmp_path / "llava")),
        lambda: image_cli.main(CacheConfig(model=str(tmp_path / "llava"), sae_path=str(tmp_path))),
        lambda: SyntheticActivationSource(),
        lambda: cli.main(CacheConfig(model="synthetic://4,1,8", sae_path=str(tmp_path))),
        lambda: Attribution(None, None, str(tmp_path), str(tmp_path / "probe.json"), selected_sae="layers.0"),
        lambda: SaeTrainer(TrainConfig(hookpoints=["layers.0"]), [], SyntheticActivationSource(d_model=4, device="cpu")),
        lambda: run(["synthetic://4,1,8", str(tmp_path / "tokens.bin")]),
        lambda: load_single_sae(str(tmp_path), "layers.0"),
        lambda: PcaReducer(),
        lambda: stats.cos(torch.eye(4)),
        lambda: stats.logits([FeatureRecord(Feature("m", 0))], torch.eye(4), torch.eye(4)),
        lambda: stats.get_neighbors({"layers.0": None}, {"layers.0": [0]}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # Named explicitly, the CPU runs the plain versions.
    assert Sae(4, SaeConfig(expansion_factor=2, k=2), device="cpu").W_enc.device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["in the repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (here), and alone in a directory without the package."""
    if alone:
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
