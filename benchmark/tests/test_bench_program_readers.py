"""The readers of the port's own spans and counters (program_readers.py):
a mean over each span's count, None where the port recorded nothing or
has no recorder."""

import types

import pytest

from benchmark import program_readers

READERS = ("sae_encode_ms", "decoder_ms", "coo_extract_ms", "vision_ms", "pixel_stage_ms", "valid_share")


def _totals(monkeypatch, value):
    from multimodal_sae_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "totals", lambda: value)


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(monkeypatch, name):
    _totals(monkeypatch, {"spans": {}, "counters": {}})
    assert getattr(program_readers, name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_recorder_reads_none(monkeypatch, name):
    import sys

    monkeypatch.setitem(sys.modules, "multimodal_sae_tpu_torch.utils.profiling", types.ModuleType("old"))
    assert getattr(program_readers, name)(None) is None


def test_means_over_the_span_count(monkeypatch):
    _totals(monkeypatch, {
        "spans": {"cache.encode": {"n": 4, "host_s": 0.1, "device_s": 6.0},
                  "cache.extract": {"n": 4, "host_s": 0.2, "device_s": None},
                  "subject.decoder": {"n": 2, "host_s": 0.1, "device_s": None}},
        "counters": {"subject.positions": 9412, "subject.valid_positions": 9000}})
    assert program_readers.sae_encode_ms(None) == pytest.approx(1500.0)
    assert program_readers.coo_extract_ms(None) == pytest.approx(50.0)
    assert program_readers.decoder_ms(None) is None  # a device span timed without CUDA
    assert program_readers.valid_share(None) == pytest.approx(100 * 9000 / 9412)
