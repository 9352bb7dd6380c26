"""What the two cache drivers share: the SAE, the closed loop through
`FeatureCache.run`, and the check of the entries the window wrote: on
rows run again through the whole reference, and on rows whose hiddens the
window kept, through the reference encoder alone.

The loop hands `FeatureCache.run` an iterator that yields the next batch
until the window closes; the port keeps its own overlap inside (the device
step of batch N runs while the host extracts the entries of batch N - 1).
The arena is pre-faulted in set-up for more entries than a window writes,
and streaming to splits stays off: a window's entries are several GB,
more than a run may write.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import weights
from ..reference.compare import compare_row, merge, topk_entries
from ..reference.lowp import Precision, full_precision
from ..reference.sae import Encoder


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *tags])


def make_sae(ctx):
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.sae import Sae

    s = ctx.config["sae"]
    params = weights.sae_params(s, ctx.seed, ctx.device)
    return Sae(s["d_in"], SaeConfig(num_latents=s["num_latents"], k=s["k"]), params=params, decoder=False)


def new_cache(cls, capture: Callable, hook: str, sae, batch_size: int, prefault_entries: int):
    fc = cls(capture, {hook: sae}, batch_size=batch_size)
    if prefault_entries:
        fc.cache.preallocate(hook, prefault_entries)
    return fc


def prefault_entries(ctx) -> int:
    """The arena's pre-faulted entries, `traffic["arena_entries"]`: sized,
    as `MMSAE_PREALLOC_MAX_ENTRIES` lets a user size it, past what a window
    writes at twice today's rate, so that no doubling of the arena (a copy
    of GBs on the host) lands inside the window."""
    return int(ctx.traffic["arena_entries"])


def plant_faults(ctx, capture: Callable) -> Callable:
    """The timed path broken underneath, for the harness's own tests:
    `stale` hands every batch the first batch's hiddens, `half_batch` keeps
    the first half of each batch's rows, `alter` gives one position the
    hidden of the position before it."""
    if not set(ctx.faults) & {"stale", "half_batch", "alter"}:
        return capture
    first = {}

    def broken(batch):
        out = capture(batch)
        if "stale" in ctx.faults:
            if not first:
                first.update({k: v.clone() for k, v in out.items()})
            out = {k: first[k][: v.shape[0], : v.shape[1]] if first[k].shape[1] >= v.shape[1] else v
                   for k, v in out.items()}
        if "half_batch" in ctx.faults:
            out = {k: v[: max(1, v.shape[0] // 2)] for k, v in out.items()}
        if "alter" in ctx.faults:
            out = {k: v.clone() for k, v in out.items()}
            for v in out.values():
                at = min(7, v.shape[1] - 1)
                v[:, at] = v[:, at - 1]
        return out

    return broken


def release(state: dict, keep=()) -> None:
    """Drop the program's state so that the reference has the card."""
    for key in [k for k in state if k not in keep]:
        del state[key]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def row_entries(locations: np.ndarray, activations: np.ndarray, rows: List[int]) -> Dict[int, tuple]:
    """{row: (positions, features, values)} of the entries of `rows`."""
    sel = np.isin(locations[:, 0], np.asarray(rows, dtype=locations.dtype))
    loc, act = locations[sel], activations[sel]
    return {r: (loc[loc[:, 0] == r, 1], loc[loc[:, 0] == r, 2], act[loc[:, 0] == r]) for r in rows}


def empty_positions(locations: np.ndarray, positions_of_row: np.ndarray) -> int:
    """Encoded positions of the window's rows (row r has
    `positions_of_row[r]`) that hold no entry: the reference writes entries
    at every position whose latents are not all under the threshold, which
    a 131,072-latent encoder of a nonzero hidden state never gives."""
    n_rows = len(positions_of_row)
    if n_rows == 0:
        return 0
    width = int(positions_of_row.max())
    rows, pos = locations[:, 0], locations[:, 1]
    ok = (rows >= 0) & (rows < n_rows) & (pos >= 0) & (pos < positions_of_row[np.clip(rows, 0, n_rows - 1)])
    seen = np.zeros(n_rows * width, dtype=bool)
    seen[rows[ok] * width + pos[ok]] = True
    return int(positions_of_row.sum() - seen.sum())


CONTROLS = {
    # The reference one step below each layer the configuration states:
    # fp8 products where it states bf16 and TF32 where it states fp32 ...
    "control.fp8": ("fp8", "tf32"),
    # ... and the encoder's step alone, the subject left in float32.
    "control.tf32": ("fp32", "tf32"),
}


def controls(ctx) -> List[str]:
    """The controls this run reads (the calibration script and the card
    test ask for them; the benchmark's runs read none)."""
    return [c for c in CONTROLS if c in ctx.faults]


def precisions(ctx) -> Dict[str, Precision]:
    """The subject's precisions the reference's hiddens are needed in:
    float32 always, fp8 where the fp8 control is read."""
    full_precision()
    out = {"fp32": Precision()}
    for c in controls(ctx):
        low = CONTROLS[c][0]
        out.setdefault(low, Precision(low=low))
    return out


class RowKeeper:
    """The hiddens the program's encoder received, kept for the encoder's
    own check: in the window, one row of each batch drawn from the seed,
    copied on the card, and of those a uniform sample of `keep` over the
    whole window (reservoir sampling: memory stays `keep` rows)."""

    def __init__(self, ctx, hook: str, batch_size: int, skip_bos: bool):
        self.rng = rng(ctx.seed, 6)
        self.keep = int(ctx.traffic["encoder_rows"])
        self.hook, self.batch_size, self.skip_bos = hook, batch_size, skip_bos
        self.on, self.batch = False, 0
        self.rows: List[tuple] = []

    def wrap(self, capture: Callable) -> Callable:
        def keeping(batch):
            out = capture(batch)
            if self.on:
                self.take(out[self.hook])
            return out

        return keeping

    def take(self, h: torch.Tensor) -> None:
        b, self.batch = self.batch, self.batch + 1
        j = int(self.rng.integers(self.batch_size))
        slot = len(self.rows) if len(self.rows) < self.keep else int(self.rng.integers(b + 1))
        if slot >= self.keep or j >= h.shape[0]:
            return
        row = (b * self.batch_size + j, h[j, 1:].clone() if self.skip_bos else h[j].clone())
        if slot == len(self.rows):
            self.rows.append(row)
        else:
            self.rows[slot] = row


def sides(ctx, entries: Dict[int, tuple], hiddens: Dict[int, Dict[str, torch.Tensor]], kept: List[tuple],
          encoder: Encoder) -> Dict[str, Dict[str, float]]:
    """The numbers compared, for the program and for each control put in
    its place (the program's `empty_positions` is over the whole window;
    the driver sets it).  On the check rows (`hiddens[row][precision]`, the
    reference's hiddens): the written entries against the float32
    reference's latents (act_err, sel_gap, bad_entries).  On the kept rows
    (the hiddens the program's encoder received): the written entries
    against the float32 reference encoder's latents of those same hiddens
    (enc_err, enc_sel).  A control's entries are its own top-k: of its
    hiddens through its encoder on the check rows, of the kept hiddens
    through its encoder on the kept rows."""
    k = ctx.config["sae"]["k"]
    names = ["program"] + controls(ctx)
    main: Dict[str, list] = {n: [] for n in names}
    enc: Dict[str, list] = {n: [] for n in names}
    for r, hs in hiddens.items():
        z = encoder.latents(hs["fp32"], Precision())
        main["program"].append(compare_row(*entries[r], z, k))
        for c in controls(ctx):
            low, encode = CONTROLS[c]
            zc = encoder.latents(hs[low], Precision(low=low, encode=encode))
            main[c].append(compare_row(*topk_entries(zc, k), z, k))
            del zc
        del z
    for r, h in kept:
        z = encoder.latents(h, Precision())
        enc["program"].append(compare_row(*entries[r], z, k))
        for c in controls(ctx):
            zc = encoder.latents(h, Precision(encode=CONTROLS[c][1]))
            enc[c].append(compare_row(*topk_entries(zc, k), z, k))
            del zc
        del z
    out = {}
    for n in names:
        m, e = merge(main[n]), merge(enc[n])
        out[n] = {"act_err": m["act_err"], "sel_gap": m["sel_gap"], "enc_err": e.get("act_err", 0.0),
                  "enc_sel": e.get("sel_gap", 0.0),
                  "bad_entries": max(m["bad_entries"], e.get("bad_entries", 0.0)),
                  "empty_positions": max(m["empty_positions"], e.get("empty_positions", 0.0))}
    return out


def run_window(ctx, state, feed) -> None:
    """`FeatureCache.run` over the batches `feed` yields, the keeper on;
    with --trace 1 the host step (the COO extraction of the batch before)
    is a span of the profile."""
    fc = state["fc"]
    if ctx.trace:
        host_step = fc._host_step

        def traced_host_step(*a, **kw):
            with ctx.span("host_step"):
                return host_step(*a, **kw)

        fc._host_step = traced_host_step
    state["keeper"].on = True
    fc.run(0, feed, progress=False)
    state["keeper"].on = False


def written(state, rows: List[int], row_positions: np.ndarray) -> tuple:
    """The window's entries of the check rows and of the kept rows, and
    the count of its encoded positions without an entry; the program's
    state is freed after, the kept hiddens kept."""
    hook = state["hook"]
    locations = state["fc"].cache.feature_locations[hook]
    activations = state["fc"].cache.feature_activations[hook]
    kept = state["keeper"].rows
    entries = row_entries(locations, activations, sorted(set(rows) | {r for r, _ in kept}))
    empty = empty_positions(locations, row_positions)
    del locations, activations
    return entries, empty, kept
