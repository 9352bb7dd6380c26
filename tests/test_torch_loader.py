"""The port's feature loading (features/loader.py, split_index.py) against the
JAX package's.

One small cache directory (numpy-seeded COO splits in the reference's
format) is read by both packages' `FeatureDataset`s with the same
constructor, sampler and transform.  The `FeatureRecord`s must be identical:
features, example tokens exactly, activations bit for bit, the `train`
selections, the explanations and the `SkipRecord` drops; on the scan path
and through `.featidx` sidecars, filtered and unfiltered, with
`MMSAE_NO_MMAP` and `MMSAE_NO_FEATIDX` set and unset, with 1 and 3 workers.
Sidecars the two packages write (by self-heal and by `ensure_index`) are
byte-equal.

Then the three faults of the JAX loader that the port fixes, each with a
test the JAX logic fails: a sidecar older than its regenerated split, an
mmap that raises, and a read-only cache's self-heal write.
"""

import hashlib
import logging
import os
import shutil
from functools import partial

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import multimodal_sae_tpu.features.constructors as jax_ctors
import multimodal_sae_tpu.features.loader as jax_loader
import multimodal_sae_tpu.features.samplers as jax_samplers
import multimodal_sae_tpu.features.split_index as jax_split_index
import multimodal_sae_tpu.launch.utils as jax_launch
import multimodal_sae_tpu_torch.features.constructors as ctors
import multimodal_sae_tpu_torch.features.loader as loader
import multimodal_sae_tpu_torch.features.samplers as samplers
import multimodal_sae_tpu_torch.features.split_index as split_index
import multimodal_sae_tpu_torch.launch.utils as launch
from multimodal_sae_tpu.config import ExperimentConfig as JaxExperimentConfig
from multimodal_sae_tpu.config import FeatureConfig as JaxFeatureConfig
from multimodal_sae_tpu_torch.config import ExperimentConfig, FeatureConfig, SaeConfig

WIDTH, N_SPLITS, ROWS, CTX = 64, 4, 24, 16
MODULES = ("layers.0", "layers.1")
SELECTED = np.array([1, 5, 17, 33, 50, 62, 63], dtype=np.int64)
FCFG = dict(width=WIDTH, n_splits=N_SPLITS, min_examples=45, max_examples=6, example_ctx_len=4)

PACKAGES = {
    "jax": dict(loader=jax_loader, ctors=jax_ctors, samplers=jax_samplers, split_index=jax_split_index,
                launch=jax_launch, fcfg=JaxFeatureConfig, ecfg=JaxExperimentConfig),
    "port": dict(loader=loader, ctors=ctors, samplers=samplers, split_index=split_index,
                 launch=launch, fcfg=FeatureConfig, ecfg=ExperimentConfig),
}


def _entries(rng, lo, hi, n=800):
    """`n` COO entries with feature ids in [lo, hi), in row-major (row,
    position, feature) order like a real cache."""
    loc = np.stack([rng.integers(0, ROWS, n), rng.integers(0, CTX, n), rng.integers(lo, hi, n)], axis=1)
    loc = loc[np.lexsort((loc[:, 2], loc[:, 1], loc[:, 0]))].astype(np.int64)
    return loc, rng.random(n).astype(np.float32)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """(cache dir, token rows): 2 modules x 4 splits of 800 entries."""
    root = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(3)
    edges = np.linspace(0, WIDTH, N_SPLITS + 1).astype(np.int64)
    for module in MODULES:
        (root / module).mkdir()
        for s, e in zip(edges[:-1], edges[1:]):
            loc, acts = _entries(rng, s, e)
            save_file({"locations": loc, "activations": acts}, str(root / module / f"{s}_{e - 1}.safetensors"))
    return root, rng.integers(0, 1000, size=(ROWS, CTX))


def _copy(root, dest):
    shutil.copytree(root, dest)
    return str(dest)


def _digests(d):
    return {
        os.path.relpath(os.path.join(p, f), d): hashlib.sha256(open(os.path.join(p, f), "rb").read()).hexdigest()
        for p, _, files in os.walk(d) for f in sorted(files)
    }


def _flat(records):
    """Records as comparable tuples: activations as bytes (bit for bit)."""
    def ex(examples):
        return [(e.tokens.dtype.str, e.tokens.tolist(), e.activations.dtype.str, e.activations.tobytes())
                for e in examples or []]

    return [(r.feature.module_name, r.feature.feature_index, r.explanation, ex(r.examples), ex(r.train))
            for r in records]


def _explanations():
    """Explanations for two of every three features: the rest are dropped
    by `sample_with_explanation` with `SkipRecord`."""
    return {f"{m}_feature{i}": f"explains {i}" for m in MODULES for i in range(WIDTH) if i % 3}


def _load(pkg, root, tokens, filtered, workers, train_type="random", modules=MODULES[:1], collate=False):
    """(records, transform call order) from package `pkg`'s FeatureDataset."""
    p = PACKAGES[pkg]
    fcfg = p["fcfg"](**FCFG)
    ecfg = p["ecfg"](train_type=train_type, n_examples_train=3, n_quantiles=2)
    features = {m: SELECTED for m in modules} if filtered else None
    ds = p["loader"].FeatureDataset(root, fcfg, modules=list(modules), features=features)
    order = []
    out = ds.load(
        collate=collate,
        constructor=partial(p["ctors"].pool_max_activation_windows, tokens=tokens, cfg=fcfg),
        sampler=partial(p["samplers"].sample_with_explanation, cfg=ecfg, explanations=_explanations()),
        transform=lambda r: order.append(r.feature.feature_index),
        num_workers=workers,
    )
    records = out if collate else [r for recs in out for r in recs]
    return records, order


class _IndexHits:
    """Wraps a loader module's `read_index`, counting sidecars read."""

    def __init__(self, monkeypatch, module):
        self.hits = self.misses = 0
        inner = module.read_index

        def wrapped(*args, **kw):
            out = inner(*args, **kw)
            if out is None:
                self.misses += 1
            else:
                self.hits += 1
            return out

        monkeypatch.setattr(module, "read_index", wrapped)


@pytest.mark.parametrize("workers", [1, 3], ids=["sequential", "3 workers"])
@pytest.mark.parametrize("env", ["default", "no_mmap_no_featidx"])
@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("path", ["scan", "sidecar"])
def test_records_identical_to_jax(cache, tmp_path, monkeypatch, path, filtered, env, workers):
    root, tokens = cache
    if env != "default":
        monkeypatch.setenv("MMSAE_NO_MMAP", "1")
        monkeypatch.setenv("MMSAE_NO_FEATIDX", "1")
    dirs = {pkg: _copy(root, tmp_path / pkg) for pkg in PACKAGES}
    if path == "sidecar":
        written = {pkg: PACKAGES[pkg]["split_index"].ensure_index(dirs[pkg]) for pkg in PACKAGES}
        assert written["jax"] == written["port"] == (0 if env != "default" else N_SPLITS * len(MODULES))
    hits = _IndexHits(monkeypatch, loader)
    got = {pkg: _load(pkg, dirs[pkg], tokens, filtered, workers, collate=filtered) for pkg in PACKAGES}
    sidecars_on = env == "default"
    n_buffers = len(np.unique(np.searchsorted(np.linspace(0, WIDTH, N_SPLITS + 1), SELECTED, "right"))) \
        if filtered else N_SPLITS
    assert (hits.hits, hits.misses) == ((n_buffers, 0) if path == "sidecar" and sidecars_on else (0, n_buffers))
    records, order = got["port"]
    assert _flat(records) == _flat(got["jax"][0])
    assert order == got["jax"][1] == [r.feature.feature_index for r in records]
    kept = {r.feature.feature_index for r in records}
    assert kept and all(i % 3 for i in kept)  # the SkipRecord drops
    assert all(len(r.train) == 3 and len(r.examples) == 6 for r in records)
    # Unfiltered scans self-heal: both packages then hold the same sidecars.
    assert _digests(dirs["port"]) == _digests(dirs["jax"])
    n_sidecars = sum(f.endswith(".featidx") for f in _digests(dirs["port"]))
    if not sidecars_on:
        assert n_sidecars == 0
    elif path == "scan":
        assert n_sidecars == (0 if filtered else N_SPLITS)


@pytest.mark.parametrize("train_type", ["top", "quantile"])
def test_other_samplers_and_the_workers_variable(cache, tmp_path, monkeypatch, train_type):
    root, tokens = cache
    monkeypatch.setenv("MMSAE_LOADER_WORKERS", "3")
    got = {pkg: _load(pkg, str(root), tokens, True, None, train_type, modules=MODULES) for pkg in PACKAGES}
    assert _flat(got["port"][0]) == _flat(got["jax"][0]) and got["port"][1] == got["jax"][1]
    monkeypatch.setenv("MMSAE_LOADER_WORKERS", "1")
    assert _flat(_load("port", str(root), tokens, True, None, train_type, modules=MODULES)[0]) == _flat(got["jax"][0])


def _outputs(buf):
    return [(o.feature.feature_index, o.locations.tolist(), o.activations.tobytes()) for o in buf]


def test_tensor_buffer_matches_jax(cache, tmp_path):
    """Every BufferOutput, the len() before a load, min_examples, and a
    filter given as floats with out-of-range ids (the LUT's hardening)."""
    root, _ = cache
    split = os.path.join(_copy(root, tmp_path / "c"), MODULES[0], "16_31.safetensors")
    for features, min_examples in ((None, 45), (np.array([17.0, 20.0, -3.0, 900.0]), 1), (np.array([500]), 1)):
        bufs = [m.TensorBuffer(split, MODULES[0], features, min_examples=min_examples) for m in (jax_loader, loader)]
        assert len(bufs[1]) == len(bufs[0])
        assert _outputs(bufs[1]) == _outputs(bufs[0])
        assert bufs[1].locations is None  # freed once drained


def test_unique_helpers_match_jax():
    rng = np.random.default_rng(0)
    for values in (rng.integers(0, 300, 500), np.array([], np.int64), np.array([5, -1, 5]), np.array([1 << 22, 3])):
        np.testing.assert_array_equal(loader._unique_nonneg(values), jax_loader._unique_nonneg(values))
    for values in (np.sort(rng.integers(0, 50, 200)).astype(np.int32), np.array([], np.int32)):
        a, b = loader._unique_sorted(values), jax_loader._unique_sorted(values)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64


def test_out_of_range_filter_ids_raise(cache):
    root, _ = cache
    for m in (jax_loader, loader):
        with pytest.raises(ValueError, match="outside"):
            m.FeatureDataset(str(root), FeatureConfig(**FCFG), features={MODULES[0]: np.array([3, WIDTH])})


def test_ensure_index_and_its_cli_match_jax(cache, tmp_path, capsys):
    root, _ = cache
    dirs = {pkg: _copy(root, tmp_path / pkg) for pkg in PACKAGES}
    assert jax_split_index.ensure_index(dirs["jax"]) == N_SPLITS * len(MODULES)
    assert split_index.main([dirs["port"]]) == 0
    assert f"wrote {N_SPLITS * len(MODULES)} feature index sidecar(s)" in capsys.readouterr().out
    assert _digests(dirs["port"]) == _digests(dirs["jax"])
    # Valid sidecars are kept, unless rebuilt; either package reads the other's.
    assert split_index.ensure_index(dirs["jax"]) == 0
    assert jax_split_index.ensure_index(dirs["port"]) == 0
    assert split_index.ensure_index(dirs["port"], rebuild=True) == N_SPLITS * len(MODULES)
    assert _digests(dirs["port"]) == _digests(dirs["jax"])


def test_write_index_with_a_given_order_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    loc, acts = _entries(rng, 0, 16)
    for pkg in PACKAGES:
        save_file({"locations": loc, "activations": acts}, str(tmp_path / f"{pkg}.safetensors"))
    order = np.argsort(loc[:, 2], kind="stable")
    assert jax_split_index.write_index(str(tmp_path / "jax.safetensors"), loc[:, 2], order=order)
    assert split_index.write_index(str(tmp_path / "port.safetensors"), loc[:, 2], order=order)
    assert open(tmp_path / "port.featidx", "rb").read() == open(tmp_path / "jax.featidx", "rb").read()


def _flags(root, filters=None, layers=()):
    flags = ["--width", str(WIDTH), "--n_splits", str(N_SPLITS), "--min_examples", "45", "--max_examples", "6",
             "--example_ctx_len", "4", "--save_dir", str(root), "--train_type", "random", "--n_examples_train", "3"]
    if filters:
        flags += ["--filters_path", filters]
    if layers:
        flags += ["--selected_layers", *map(str, layers)]
    return flags


def _loader_records(pkg, flags, tokens):
    p = PACKAGES[pkg]
    args = p["launch"].parse_feature_experiment(flags)
    ctor = partial(p["ctors"].pool_max_activation_windows, tokens=tokens, cfg=args.feature)
    load, modules = p["launch"].build_feature_loader(args, ctor, partial(p["samplers"].sample, cfg=args.experiment))
    return modules, _flat(load(collate=True))


def test_build_feature_loader_matches_jax(cache, tmp_path):
    root, tokens = cache
    root = _copy(root, tmp_path / "c")
    filt = tmp_path / "filter.json"
    filt.write_text('{"layers.1": [2, 40, 41]}')
    for flags in (_flags(root), _flags(root, str(filt)), _flags(root, layers=[1])):
        a, b = _loader_records("port", flags, tokens), _loader_records("jax", flags, tokens)
        assert a == b and a[1]
    assert launch.select_modules(str(root), None, [1]) == ["layers.1"]
    for extra in ([], ["--width", "7", "--selected_layers", "0", "3", "--filters_path", "f.json"]):
        a, b = launch.parse_feature_experiment(extra), jax_launch.parse_feature_experiment(extra)
        assert vars(a.feature) == vars(b.feature) and vars(a.experiment) == vars(b.experiment)


def test_slice_end_to_end(tmp_path):
    """The port's cache writer on a tiny subject, then both packages'
    build_feature_loader over what it wrote: identical records."""
    from multimodal_sae_tpu_torch.features import FeatureCache
    from multimodal_sae_tpu_torch.sae import Sae

    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    sae = Sae(16, SaeConfig(num_latents=WIDTH, k=8), device="cpu", seed=1)
    rows = [{"input_ids": rng.integers(0, 50, size=CTX)} for _ in range(ROWS)]
    fc = FeatureCache(lambda b: {"layers.0": table[torch.as_tensor(b["input_ids"])]}, {"layers.0": sae}, batch_size=4)
    fc.run(CTX, rows, progress=False)
    save_dir = tmp_path / "cache"
    fc.save_splits(N_SPLITS, str(save_dir))
    fc.concate_safetensors(N_SPLITS, str(save_dir))
    tokens = np.stack([r["input_ids"] for r in rows])
    flags = _flags(save_dir)
    flags[flags.index("--min_examples") + 1] = "10"
    port, jax = _loader_records("port", flags, tokens), _loader_records("jax", flags, tokens)
    assert port == jax and len(port[1]) > 10


# ---- the three faults of the JAX loader, fixed in the port ---------------------------


def _rewrite(split, seed, split_mtime_ns, sidecar_mtime_ns):
    """Regenerate `split` with the same entry count (so the same byte size)
    and other feature ids, then set both files' mtimes."""
    loc, acts = _entries(np.random.default_rng(seed), 0, 16)
    save_file({"locations": loc, "activations": acts}, split)
    os.utime(split, ns=(split_mtime_ns, split_mtime_ns))
    sidecar = split_index.index_path(split)
    os.utime(sidecar, ns=(sidecar_mtime_ns, sidecar_mtime_ns))


@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("caught_by", ["mtime", "spot check"])
def test_stale_sidecar_of_a_regenerated_split_is_not_used(tmp_path, monkeypatch, caught_by, filtered):
    """Fault 1: the JAX check compares the entry count and byte size only.
    A split regenerated with the same count beside an older sidecar must
    read as the new split.  The spot check catches it too when a copy has
    made the sidecar the newer file."""
    split = str(tmp_path / "m" / "0_15.safetensors")
    os.makedirs(os.path.dirname(split))
    save_file(dict(zip(("locations", "activations"), _entries(np.random.default_rng(0), 0, 16))), split)
    assert split_index.ensure_index(str(tmp_path)) == 1
    sidecar = split_index.index_path(split)
    t = os.stat(sidecar).st_mtime_ns
    old_bytes = open(sidecar, "rb").read()
    older, newer = t - 2 * 10**9, t - 10**9
    _rewrite(split, 1, *((newer, older) if caught_by == "mtime" else (older, newer)))
    assert os.path.getsize(split) == int(split_index.mmap_safetensors(sidecar)["meta"][1])
    features = np.arange(16) if filtered else None

    def outputs():
        return _outputs(loader.TensorBuffer(split, "m", features, min_examples=1))

    got = outputs()
    monkeypatch.setenv("MMSAE_NO_FEATIDX", "1")
    assert got == outputs()  # the new split's scan
    monkeypatch.delenv("MMSAE_NO_FEATIDX")
    healed = open(sidecar, "rb").read() != old_bytes
    assert healed == (not filtered)  # an unfiltered scan rewrote the sidecar
    if healed:
        feats = split_index.mmap_safetensors(split)["locations"][:, 2]
        assert split_index.read_index(split, len(feats), feats) is not None
        assert outputs() == got


@pytest.mark.parametrize("error", [OSError, ValueError])
def test_mmap_failure_falls_back_to_a_full_read(cache, tmp_path, monkeypatch, error):
    """Fault 2: an OSError or ValueError from the mmap reads the whole file."""
    root, tokens = cache
    want = _flat(_load("port", str(root), tokens, True, 1)[0])
    failed = []

    def fail(path):
        failed.append(path)
        raise error(f"cannot map {path}")

    monkeypatch.setattr(loader, "mmap_safetensors", fail)
    assert _flat(_load("port", str(root), tokens, True, 1)[0]) == want
    assert len(failed) == N_SPLITS


def test_self_heal_on_a_read_only_cache_is_tried_once(cache, tmp_path, monkeypatch, caplog):
    """Fault 3: the self-heal write fails on a read-only directory; two
    unfiltered loads of two splits try it once and warn once."""
    root, tokens = cache
    d = _copy(root, tmp_path / "ro")
    attempts = []

    def read_only(*args, **kw):
        attempts.append(kw.get("dir"))
        raise PermissionError(13, "Read-only file system")

    monkeypatch.setattr(split_index.tempfile, "mkstemp", read_only)
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            ds = loader.FeatureDataset(d, FeatureConfig(**FCFG), modules=[MODULES[0]])
            for buffer in ds.buffers[:2]:
                assert sum(1 for _ in buffer) > 0
    warnings = [r for r in caplog.records if "could not write feature index" in r.getMessage()]
    assert len(attempts) == 1 and len(warnings) == 1
    assert not any(f.endswith(".featidx") for f in os.listdir(os.path.join(d, MODULES[0])))
