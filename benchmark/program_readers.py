"""The per-layer readers of the port's own spans and counters: the totals
`multimodal_sae_tpu_torch.utils.profiling.totals()` holds after the
window, recorded while the traced window's profiler ran (the port records
nothing otherwise).  One function a quantity; each file under
`layer_metrics/` names one of them for one cell's metric.  A reader
returns None where the totals hold nothing to read: an untraced run, a
device span without CUDA, or a port without the recorder.  A mean is over
the span's count: one a batch and hookpoint."""

from typing import Optional


def _totals() -> Optional[dict]:
    try:
        from multimodal_sae_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    return totals()


def _mean_ms(name: str, clock: str) -> Optional[float]:
    t = _totals()
    s = t["spans"].get(name) if t else None
    if not s or not s["n"] or s[clock] is None:
        return None
    return 1e3 * s[clock] / s["n"]


def sae_encode_ms(trace):
    """`cache.encode`: the SAE encode, K1's top-k and the sort by feature
    index of a batch's hookpoint, device time (CUDA events)."""
    return _mean_ms("cache.encode", "device_s")


def decoder_ms(trace):
    """`subject.decoder`: the subject's decoder call a batch, device time."""
    return _mean_ms("subject.decoder", "device_s")


def coo_extract_ms(trace):
    """`cache.extract`: the host COO extraction of a batch's hookpoint
    (`Cache.add_topk`), host time."""
    return _mean_ms("cache.extract", "host_s")


def vision_ms(trace):
    """`llava.vision`: the CLIP tower, projector and anyres pack of a
    batch's images, device time."""
    return _mean_ms("llava.vision", "device_s")


def pixel_stage_ms(trace):
    """`llava.stage_pixels`: a batch's pixel arrays stacked per geometry on
    the host and copied to the card, host time.  The copy, from pageable
    memory, blocks until the card has run the work queued before it, so
    the span holds that wait too."""
    return _mean_ms("llava.stage_pixels", "host_s")


def valid_share(trace):
    """The share of the positions the decoder runs that the masks passed to
    it attend (`subject.valid_positions` over `subject.positions`)."""
    t = _totals()
    counters = t["counters"] if t else {}
    positions = counters.get("subject.positions")
    if not positions:
        return None
    return 100.0 * counters.get("subject.valid_positions", 0) / positions
