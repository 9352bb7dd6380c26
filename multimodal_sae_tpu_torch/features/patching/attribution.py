"""Attribution patching (multimodal_sae_tpu/features/patching/attribution.py).

Per feature f: splice the SAE reconstruction into the hooked layer (clean),
splice it with f ablated (corrupted), and accumulate
`(clean - corrupted) · d(metric)/d(corrupted)` over the hidden dim into a
(batch, seq) saliency map.

* The fast path (one hookpoint, a model with `forward_from_layer`) splits
  the network at the splice: layers 0..hook, the (B·S, width)
  pre-activation matmul and a top-(k+1) pool run once; per feature only the
  dropped feature's pool positions, the splice (kernel K2's splice mode,
  which reads each token's pool once for all F features of a chunk) and the
  layers above the hook run, forward and backward (kernel K3 both ways).
  The JAX package vmaps the per-feature step; here a chunk of F features is
  stacked on the batch axis (x is (F·B, S, D)), their metrics are summed,
  and one backward gives each feature its own gradient.
* The general path (several hookpoints, or a model without
  `forward_from_layer`) runs the full spliced forward and backward once per
  feature.  The JAX package may vmap it; the results are the same.
"""

from __future__ import annotations

import collections
import json
import logging
import os
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, set_precision
from ...ops.gather_rows import drop_positions, splice_decode, splice_lists
from ...sae import Sae, decode, pre_acts, select_topk
from .utils import get_logit_diff, spliced_forward_with_delta

logger = logging.getLogger(__name__)


class FastAttribution:
    """The prefix/suffix attribution step of one (model, hook, SAE, batch,
    metric); `__call__(feats)` gives the (F, B, S) saliency of a chunk.

    Built by `build_fast_attribution`, which runs the prefix at once: the
    capture of the hook's raw output, its top-(k+1) pool of latents and the
    clean splice.  The pool comes out of `select_topk` in descending order,
    and both the clean top-k and every corrupted one are read from it in
    that order: the clean one is its first k entries, the corrupted one the
    first k that are not the ablated feature.  A feature outside a token's
    top-k therefore leaves that token's selection, and (the decode being
    deterministic) its splice, unchanged bit for bit, so its saliency there
    is exactly 0.  Post-ReLU latents are >= 0, so dropping a feature from
    the pool is the reference's zeroing of its column; in the degenerate
    k == width case the dropped slot decodes as 0, as there."""

    def __init__(self, model, hook: str, sae: Sae, batch: dict, metric: Callable):
        # The fp32 prefix encode runs with TF32 off, as the cache path runs
        # it: TF32 would move the top-k boundaries the pool is read from.
        set_precision()
        self.model, self.hook, self.sae, self.metric = model, hook, sae, metric
        self.mask = batch.get("attention_mask")
        with torch.no_grad():
            h_raw = model.capture(batch, [hook])[hook]
            self.B, self.S, D = h_raw.shape
            self.k = sae.cfg.k
            width = sae.cfg.num_latents_for(sae.d_in)
            self.k_wide = min(self.k + 1, width)
            latents = pre_acts(sae.params, h_raw.reshape(-1, D))
            self.wide_vals, self.wide_idx = select_topk(latents, self.k_wide)
            del latents
            self.clean = decode(
                sae.params, self.wide_vals[:, : self.k], self.wide_idx[:, : self.k]
            ).reshape(self.B, self.S, D).to(h_raw.dtype)

    def drop_positions(self, feats: torch.Tensor) -> torch.Tensor:
        """(F, B·S) int32: feature feats[f]'s position in each token's pool,
        k_wide where it is absent."""
        return drop_positions(self.wide_idx, feats)

    def reselect(self, feats: torch.Tensor):
        """(vals, idx), each (F·B·S, k): every token's top-k with feature
        feats[f] dropped, read in the pool's order.  The splice reads the
        same lists from the pool itself (`splice_decode`); this spells them
        out, for comparison."""
        pos = self.drop_positions(feats)  # (F, N)
        rows = torch.arange(self.wide_idx.shape[0], device=pos.device).repeat(feats.shape[0])
        return splice_lists(self.wide_idx, self.wide_vals, rows, pos.reshape(-1), self.k)

    def __call__(self, feats: torch.Tensor, mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
        """(F, B, S) saliency of features `feats` (F,).  `mark(stage)` is
        called after each stage ("reselect", "decode", "forward",
        "backward", "saliency"); a caller may time the stages with it."""
        mark = mark or (lambda stage: None)
        F, B, S = feats.shape[0], self.B, self.S
        params = self.sae.params
        with torch.no_grad():
            drop = self.drop_positions(feats)
            mark("reselect")
            spliced = splice_decode(
                self.wide_idx, self.wide_vals.to(params["W_dec"].dtype), drop, self.k, params["W_dec"],
                params["b_dec"], self.clean.reshape(B * S, -1),
            ).reshape(F * B, S, -1)
            mark("decode")
        delta = torch.zeros(spliced.shape, dtype=torch.float32, device=spliced.device, requires_grad=True)
        x = spliced + delta.to(spliced.dtype)
        batch = {} if self.mask is None else {"attention_mask": np.tile(np.asarray(self.mask), (F, 1))}
        logits = self.model.forward_from_layer(x, self.hook, batch)
        metric = sum(self.metric(logits[f * B : (f + 1) * B]) for f in range(F))
        mark("forward")
        (grad,) = torch.autograd.grad(metric, delta)
        mark("backward")
        with torch.no_grad():
            diff = self.clean[None] - spliced.view(F, B, S, -1)
            sal = (diff * grad.view(F, B, S, -1)).sum(-1)
        mark("saliency")
        return sal


def build_fast_attribution(model, hook: str, sae: Sae, batch: dict, metric: Callable) -> FastAttribution:
    """Run the prefix and return the per-chunk step (see FastAttribution)."""
    return FastAttribution(model, hook, sae, batch, metric)


def _progress(total: int, enabled: bool):
    if not enabled:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total, desc="Calculating attribution")


def fast_attribution_maps(
    model,
    hook: str,
    sae: Sae,
    batch: dict,
    metric: Callable,
    indices,
    feature_batch: int = 8,
    progress: bool = True,
) -> Dict[str, List[np.ndarray]]:
    """Prefix/suffix attribution at one hookpoint, `feature_batch` features
    per chunk (the ragged tail padded with its last feature, then trimmed).
    A chunk that runs out of device memory is retried at half the width,
    down to 1.  Returns {hook: [(B, S) saliency per feature]}."""
    set_precision()
    indices = np.asarray(indices)
    step = build_fast_attribution(model, hook, sae, batch, metric)
    pbar = _progress(len(indices), progress)
    out = collections.defaultdict(list)
    i = 0
    while i < len(indices):
        chunk = indices[i : i + feature_batch]
        keep = len(chunk)
        if keep < feature_batch:  # ragged tail: pad then trim
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], feature_batch - keep)])
        try:
            sal = step(torch.as_tensor(chunk, dtype=torch.long)).float().cpu().numpy()
        except torch.cuda.OutOfMemoryError:
            # The stacked backward's memory grows with the chunk; halve and
            # retry instead of dying mid-sweep.
            if feature_batch <= 1:
                raise
            feature_batch = max(1, feature_batch // 2)
            torch.cuda.empty_cache()
            logger.warning(f"attribution feature batch ran out of memory; retrying with feature_batch={feature_batch}")
            continue
        out[hook].extend(list(sal[:keep]))
        i += keep
        if pbar:
            pbar.update(keep)
    return dict(out)


def general_attribution_maps(
    model,
    sae_dict: Dict[str, Sae],
    batch: dict,
    metric: Callable,
    indices,
    progress: bool = True,
) -> Dict[str, List[np.ndarray]]:
    """The full-forward formulation: per feature, the spliced forward with
    that feature ablated at every hookpoint, and the gradient at each splice.
    The clean splice does not depend on the feature and runs once.

    One hookpoint only: with several, the gradient runs through the upper
    splice's encode and decode, a path not yet held against the JAX package
    (ROADMAP.md §1), so it is refused."""
    if len(sae_dict) != 1:
        raise NotImplementedError(
            "the general attribution path over several hookpoints is not ported yet: ROADMAP.md §1 "
            "(it differentiates the upper splice's decode, whose backward came with the training slice)"
        )
    names = tuple(sae_dict)
    B, S = np.asarray(batch["input_ids"]).shape
    zeros = {
        name: torch.zeros(B, S, sae.d_in, dtype=torch.float32, device=sae.b_dec.device)
        for name, sae in sae_dict.items()
    }
    with torch.no_grad():
        _, clean = spliced_forward_with_delta(model, batch, sae_dict, zeros, off_feature=None)
    pbar = _progress(len(indices), progress)
    out = collections.defaultdict(list)
    for f in np.asarray(indices):
        deltas = {name: z.clone().requires_grad_() for name, z in zeros.items()}
        logits, corrupted = spliced_forward_with_delta(model, batch, sae_dict, deltas, off_feature=int(f))
        grads = torch.autograd.grad(metric(logits), [deltas[name] for name in names])
        with torch.no_grad():
            for name, grad in zip(names, grads):
                sal = ((clean[name] - corrupted[name]) * grad).sum(-1)
                out[name].append(sal.float().cpu().numpy())
        if pbar:
            pbar.update(1)
    return dict(out)


def repack_left_padded(batch: dict) -> dict:
    """Move every row's valid tokens to the end (left padding), so the last
    position is each row's last real token (multimodal_sae_tpu/models/
    llava_next.py::_repack_left_padded)."""
    amask = batch.get("attention_mask")
    if amask is None:
        return batch
    am = np.asarray(amask)
    ids = np.asarray(batch["input_ids"])
    if not (am == 0).any():
        return batch
    new_ids = np.zeros_like(ids)
    new_am = np.zeros_like(am)
    for i in range(am.shape[0]):
        valid = ids[i][am[i].astype(bool)]
        if len(valid):
            new_ids[i, -len(valid):] = valid
            new_am[i, -len(valid):] = 1
    return {**batch, "input_ids": new_ids, "attention_mask": new_am}


class Attribution:
    """Args mirror the reference: a subject model, a tokenizer, a local SAE
    directory, and a probing json of {"prompt", "answer", "baseline",
    "image"} rows.  The SAE loads with its decoder on `device` (the card
    unless the caller names another)."""

    def __init__(
        self,
        model,
        tokenizer,
        sae_path: str,
        data_path: str,
        selected_sae: Optional[str] = None,
        feature_batch: int = 0,
        device: DeviceLike = None,
    ) -> None:
        # feature_batch 0 = auto (by prompt length) on the fast path; the
        # general path runs one feature at a time whatever it is.
        self.model = model
        self.tokenizer = tokenizer
        self.feature_batch = feature_batch
        dev = resolve_device(device)
        set_precision()
        if not os.path.isdir(sae_path):
            raise FileNotFoundError(f"{sae_path} is not a local SAE directory (hub downloads need a network)")
        if selected_sae is not None:
            self.sae_dict = {selected_sae: Sae.load_from_disk(os.path.join(sae_path, selected_sae), device=dev)}
        else:
            self.sae_dict = Sae.load_many(sae_path, device=dev)

        with open(data_path, "r") as f:
            self.data = json.load(f)

        from PIL import Image

        prompts, answers, images = [], [], []
        for item in self.data:
            prompts.append(item["prompt"])
            answers.append([str(item["answer"]), str(item["baseline"])])
            images.append(Image.open(item["image"]))

        # Prompts drop the BOS, answers go through convert_tokens_to_ids, as
        # in the reference.
        prompt_ids = [tokenizer(p)["input_ids"][1:] for p in prompts]
        self.answer_ids = np.array(
            [[tokenizer.convert_tokens_to_ids(a[0]), tokenizer.convert_tokens_to_ids(a[1])] for a in answers],
            dtype=np.int64,
        )
        # The metric reads the last position: left padding makes it every
        # row's last real token.
        self.batch = repack_left_padded(self.model.prepare_inputs(images=images, prompt_ids=prompt_ids))
        am = self.batch.get("attention_mask")
        if am is not None and np.asarray(am).all():
            self.batch = {k: v for k, v in self.batch.items() if k != "attention_mask"}
        self.metric = partial(get_logit_diff, answer_token_indices=torch.as_tensor(self.answer_ids, device=dev))

    def get_attribution(self, indices: Optional[List[int]] = None) -> Dict[str, List[np.ndarray]]:
        saes = list(self.sae_dict.values())
        if indices is None:
            first = saes[0]
            indices = np.arange(first.cfg.num_latents_for(first.d_in))
        indices = np.asarray(indices)
        if len(self.sae_dict) == 1 and hasattr(self.model, "forward_from_layer"):
            ((hook, sae),) = self.sae_dict.items()
            fb = self.feature_batch
            if not fb or fb < 1:
                # The JAX package's auto width: wide chunks for short
                # prompts, one feature at a time for long ones.
                fb = 32 if np.asarray(self.batch["input_ids"]).shape[-1] < 512 else 1
            return fast_attribution_maps(self.model, hook, sae, self.batch, self.metric, indices, feature_batch=fb)
        return general_attribution_maps(self.model, self.sae_dict, self.batch, self.metric, indices)
