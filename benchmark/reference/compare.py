"""The comparison that decides `correct` for a feature cache: the COO
entries the program wrote for one row against the reference's latents of
that row.

For each encoded position p the reference gives latents z (post-ReLU) and
its k-th largest value t_p.  Every number is a share of t_p:

* act_err: the largest |written activation - z[p, f]| over the row's
  entries;
* sel_gap: the widest gap by which the written selection departs from
  the reference's top-k: a written feature lying below t_p, or a feature
  of the reference's top-k that was not written lying above it (ties at
  the k-th value cost nothing);
* bad_entries: entries outside the row's positions or the latent range,
  (position, feature) pairs written twice, and positions whose number of
  entries differs from the number of the reference's top-k values above
  the cache's threshold (1e-5);
* empty_positions: the row's positions without an entry.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

THRESHOLD = 1e-5


def compare_row(pos: np.ndarray, feat: np.ndarray, act: np.ndarray, z: torch.Tensor, k: int) -> Dict[str, float]:
    """pos, feat, act: the row's entries (positions, features, values); z
    (P, L) the reference's latents of its P encoded positions."""
    P, L = z.shape
    dev = z.device
    bad = int(((pos < 0) | (pos >= P) | (feat < 0) | (feat >= L)).sum())
    keep = (pos >= 0) & (pos < P) & (feat >= 0) & (feat < L)
    pos_t = torch.as_tensor(pos[keep], dtype=torch.long, device=dev)
    feat_t = torch.as_tensor(feat[keep], dtype=torch.long, device=dev)
    act_t = torch.as_tensor(act[keep], dtype=torch.float32, device=dev)
    key = pos_t * L + feat_t
    bad += int(key.numel() - torch.unique(key).numel())
    top = torch.topk(z, k, dim=-1)
    kth = top.values[:, -1]
    scale = kth.clamp_min(1e-12)
    want = (top.values > THRESHOLD).sum(-1)
    got = torch.bincount(pos_t, minlength=P)
    bad += int((got != want).sum())
    ref = z[pos_t, feat_t]
    act_err = ((act_t - ref).abs() / scale[pos_t]).max().item() if len(act_t) else 0.0
    below = ((kth[pos_t] - ref).clamp_min(0) / scale[pos_t]).max().item() if len(act_t) else 0.0
    written = torch.zeros(P, L, dtype=torch.bool, device=dev)
    written[pos_t, feat_t] = True
    missed_mask = ~written.gather(1, top.indices)
    above = (top.values - kth[:, None]) / scale[:, None]
    missed = above[missed_mask].max().item() if bool(missed_mask.any()) else 0.0
    return {"act_err": act_err, "sel_gap": max(below, missed), "bad_entries": float(bad),
            "empty_positions": float((got == 0).sum())}


def merge(rows) -> Dict[str, float]:
    """The worst reading of each number over the compared rows."""
    out: Dict[str, float] = {}
    for r in rows:
        for name, v in r.items():
            out[name] = max(out.get(name, 0.0), v)
    return out


def topk_entries(z: torch.Tensor, k: int):
    """A control's entries of one row, as a cache writes them: its top-k
    above the threshold, (positions, features, values) as numpy arrays."""
    vals, idx = torch.topk(z, k, dim=-1)
    pos = torch.arange(z.shape[0], device=z.device)[:, None].expand_as(idx)
    m = vals > THRESHOLD
    return pos[m].cpu().numpy(), idx[m].cpu().numpy(), vals[m].float().cpu().numpy()
