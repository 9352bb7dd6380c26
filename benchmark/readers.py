"""The per-layer readers' arithmetic, one function a quantity; each file
under `layer_metrics/` names one of them for one cell kind's metric.
A reader returns None where the trace holds nothing to read."""

from benchmark.counts.work import ideal_seconds, k3_fwd_bound_s, topk_k1_bound_s


def idle_share(trace):
    """The share of the traced window in which no operation ran on the
    card (torch.profiler's device intervals, merged)."""
    if trace.busy_s is None or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace):
    """The least time the window's required operations take at the card's
    peaks (bf16 subject and tower at 989 TFLOP/s, the fp32 encoder at 67
    TFLOP/s; valid positions only), as a share of the traced window."""
    if not trace.work or not trace.window_s:
        return None
    return 100.0 * ideal_seconds(trace.work) / trace.window_s


def k1_roofline(trace):
    """K1 (`block_max_kernel`) over the window: the bytes bound of the
    exact top-k's two launches an encoded batch (the latents in blocks of
    64, then the k * 64 candidates in blocks of 8; pads included, as the
    cache encodes them) over their device time."""
    k = trace.kernel("block_max_kernel")
    bound, launches = 0.0, 0
    for item in trace.work:
        if item["kind"] == "sae_encode":
            bound += topk_k1_bound_s(item["positions"], item["latents"], item["k"])
            launches += 2
    if not launches or k["count"] != launches or k["s"] <= 0:
        return None
    return 100.0 * bound / k["s"]


def k3_fwd_roofline(trace):
    """K3's forward (`flash_fwd_kernel`) over the window: the sum of its
    launches' bounds (causal work of the valid rows, counts/work.py) over
    the sum of their device time.  One launch a decoder layer of each
    batch; read only when the profile holds exactly those launches."""
    k = trace.kernel("flash_fwd_kernel")
    bound, launches = 0.0, 0
    for item in trace.work:
        if item["kind"] != "llama":
            continue
        t = item["text"]
        H, kvH = t["num_attention_heads"], t["num_key_value_heads"]
        hd = t.get("head_dim") or t["hidden_size"] // H
        bound += item["layers"] * k3_fwd_bound_s(item["B"], H, kvH, item["S"], hd, item["valid"])["s"]
        launches += item["layers"]
    if not launches or k["count"] != launches or k["s"] <= 0:
        return None
    return 100.0 * bound / k["s"]


def subject_forward_ms(trace):
    """The device time of the capture the benchmark hands to the cache
    (CUDA events around it), the mean over the window's batches."""
    ms = trace.spans.get("capture")
    if not ms:
        return None
    return sum(ms) / len(ms)
