"""The port's spans and counters (multimodal_sae_tpu_torch/utils/profiling.py)
on the CPU: they record only while a `torch.profiler` records, as
`mmsae.*` operators of the profile with their totals beside; the cache
loop, the LLaVA subject and the cache CLI record where their work happens,
and what a cache writes does not depend on recording.  `utils.timed`
synchronises the card around its clock reads."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.features import FeatureCache
from multimodal_sae_tpu_torch.sae import Sae
from multimodal_sae_tpu_torch.utils import profiling

HOOK = "layers.1"


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _cache(batch_size=2):
    sae = Sae(16, SaeConfig(num_latents=256, k=8), seed=4, device="cpu")
    weights = torch.randn(64, 16, generator=torch.Generator().manual_seed(3))

    def capture(batch):
        return {HOOK: weights[torch.as_tensor(np.asarray(batch["input_ids"]))]}

    return FeatureCache(capture, {HOOK: sae}, batch_size=batch_size)


def _rows(n=10, seq=6):
    return [{"input_ids": r} for r in np.random.default_rng(7).integers(0, 64, size=(n, seq))]


def test_off_records_nothing_and_makes_no_cuda_event(monkeypatch):
    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made while no profiler recorded")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not profiling.recording()
    assert profiling.span("a", device=True, batch=1) is profiling.span("b")
    with profiling.span("a", device=True, batch=1):
        profiling.count("c", 3)
    fc = _cache()
    fc.run(6, _rows(), progress=False)
    assert fc.cache._arenas[HOOK].n > 0
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_spans_are_profiler_operators_with_their_batch_and_parent(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        made.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with _recording() as prof:
        with profiling.span("outer", batch=3):
            with profiling.span("inner"):
                torch.ones(4).add_(1)
    assert made == [("mmsae.outer", "3"), ("mmsae.inner", None)]
    events = {e.name: e for e in prof.events() if e.name.startswith("mmsae.")}
    assert set(events) == {"mmsae.outer", "mmsae.inner"}
    assert events["mmsae.inner"].cpu_parent.name == "mmsae.outer"
    assert any(c.name == "aten::add_" for c in events["mmsae.inner"].cpu_children)
    spans = profiling.totals()["spans"]
    assert {k: v["n"] for k, v in spans.items()} == {"outer": 1, "inner": 1}
    assert spans["outer"]["host_s"] >= spans["inner"]["host_s"] > 0
    assert spans["outer"]["device_s"] is None


@pytest.mark.parametrize("n_batches", [1, 5])
def test_cache_run_records_one_span_a_batch(n_batches):
    fc = _cache()
    with _recording() as prof:
        fc.run(6, _rows(2 * n_batches), progress=False)
    t = profiling.totals()
    for name in ("cache.encode", "cache.wait", "cache.extract"):
        assert t["spans"][name]["n"] == n_batches, name
    # `run` pre-faults the arena inside the profile: one reallocation.
    assert t["spans"]["cache.arena_grow"]["n"] == 1
    arena = fc.cache._arenas[HOOK]
    assert t["counters"]["cache.arena_grow_bytes"] == arena.loc.nbytes + arena.act.nbytes
    extract = [e for e in prof.events() if e.name == "mmsae.cache.extract"]
    assert len(extract) == n_batches


def test_cache_entries_do_not_depend_on_recording():
    plain = _cache()
    plain.run(6, _rows(), progress=False)
    traced = _cache()
    with _recording():
        traced.run(6, _rows(), progress=False)
    assert profiling.totals()["spans"]["cache.extract"]["n"] == 5
    for module in (HOOK,):
        a, b = plain.cache.feature_locations[module], traced.cache.feature_locations[module]
        assert a.tobytes() == b.tobytes() and len(a) > 0
        a, b = plain.cache.feature_activations[module], traced.cache.feature_activations[module]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_llava_counts_the_masks_ones_and_spans_its_parts():
    from multimodal_sae_tpu_torch.models import llava_next as ln
    from torch_llava_tiny import BOS, IMG_TOKEN, hf_config, images

    cfg = ln.LlavaNextConfig.from_hf(hf_config().to_dict())
    model = ln.LlavaNextModel.random(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = model.prepare_inputs(images=images([(50, 70), (90, 40), (64, 64)]), prompt_ids=[[BOS, IMG_TOKEN]] * 3)
    mask = batch["attention_mask"]
    assert 0 < mask.sum() < mask.size
    with _recording():
        out = model.capture(batch, ["model.layers.1"])
    t = profiling.totals()
    assert t["counters"] == {"subject.positions": mask.size, "subject.valid_positions": int(mask.sum())}
    assert {k: v["n"] for k, v in t["spans"].items()} == {
        "llava.stage_pixels": 1, "llava.vision": 1, "subject.decoder": 1}
    plain = model.capture(batch, ["model.layers.1"])
    assert torch.equal(out["model.layers.1"], plain["model.layers.1"])


def test_text_subject_counts_the_positions_its_decoder_runs():
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel

    cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.float32, device="cpu")
    ragged = model.prepare_inputs(input_ids=[[1, 2, 3, 4], [5, 6]])
    full = {"input_ids": np.ones((2, 3), np.int64), "attention_mask": np.ones((2, 3), np.int64)}
    with _recording():
        model.capture({"input_ids": np.ones((2, 4), np.int64)}, ["layers.1"])
        assert profiling.totals()["counters"] == {"subject.positions": 8, "subject.valid_positions": 8}
        model.capture(full, ["layers.1"])  # an all-ones mask reaches the decoder as none
        model.capture(ragged, ["layers.1"])
    t = profiling.totals()
    assert t["counters"] == {"subject.positions": 8 + 6 + 8, "subject.valid_positions": 8 + 6 + 6}
    assert t["spans"]["subject.decoder"]["n"] == 3


class _FakeEvent:
    """A CUDA event's timing calls, completed by hand."""

    made = []
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done, self.t = False, None
        _FakeEvent.made.append(self)

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        # A stream's end event completes after its start event.
        assert end.done
        return 1000.0 * (end.t - self.t)


def test_device_spans_fold_lazily_without_a_device_wide_synchronise(monkeypatch):
    def no_sync(*a, **kw):
        raise AssertionError("device-wide synchronise")

    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with _recording():
        for _ in range(3):
            with profiling.span("d", device=True):
                pass
            # The span before has completed by now: the next exit folds it.
            for e in _FakeEvent.made:
                e.done = True
        with profiling.span("d", device=True):
            pass
    assert len(profiling._pending) == 1
    t = profiling.totals()["spans"]["d"]
    assert not profiling._pending
    assert t["n"] == 4 and t["device_s"] == pytest.approx(4.0)


def test_maybe_trace_resets_the_totals_and_writes_them(tmp_path, monkeypatch):
    monkeypatch.delenv("MMSAE_PROFILE_DIR", raising=False)
    with _recording():
        with profiling.span("before"):
            pass
    assert "before" in profiling.totals()["spans"]
    with profiling.maybe_trace("job", log_dir=str(tmp_path)):
        with profiling.span("inside", batch=0):
            profiling.count("things", 2)
    written = json.loads((tmp_path / "job" / "rank0.spans.json").read_text())
    assert (tmp_path / "job" / "rank0.trace.json").exists()
    assert set(written["spans"]) == {"inside"} and written["spans"]["inside"]["n"] == 1
    assert written["counters"] == {"things": 2}


def test_timed_synchronises_the_card_around_its_clock_reads(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("sync"))
    seen = []
    with profiling.timed("step", sink=lambda label, s: seen.append((label, s))):
        assert calls == ["sync"]
    assert calls == ["sync", "sync"] and [label for label, _ in seen] == ["step"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with profiling.timed("step", sink=lambda label, s: None):
        pass
    assert calls == ["sync", "sync"]
    with _recording():
        with profiling.timed("step", sink=lambda label, s: None):
            pass
    assert profiling.totals()["spans"]["step"]["n"] == 1


def test_cache_cli_writes_the_span_summary(tmp_path, monkeypatch):
    from datasets import Dataset

    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.launch.cache import cache as port_cli

    ids = np.random.default_rng(6).integers(0, 32, size=(6, 12))
    Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(str(tmp_path / "ds"))
    Sae(16, SaeConfig(num_latents=256, k=8), seed=4, device="cpu").save_to_disk(tmp_path / "saes" / "layers.2")
    monkeypatch.setenv("MMSAE_PROFILE_DIR", str(tmp_path / "prof"))
    port_cli.main(
        CacheConfig(model="synthetic://16,3,32", dataset=str(tmp_path / "ds"), sae_path=str(tmp_path / "saes"),
                    batch_size=2, ctx_len=12, n_splits=4, save_dir=str(tmp_path / "cli")),
        device="cpu",
    )
    summary = json.loads((tmp_path / "prof" / "cache" / "rank0.spans.json").read_text())
    n = {k: v["n"] for k, v in summary["spans"].items()}
    assert n["cache.encode"] == n["cache.wait"] == n["cache.extract"] == 3
    assert n["cache.stream_submit"] == 3
    trace = json.loads((tmp_path / "prof" / "cache" / "rank0.trace.json").read_text())
    assert any(e.get("name") == "mmsae.cache.extract" for e in trace["traceEvents"])
