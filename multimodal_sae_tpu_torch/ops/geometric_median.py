"""Geometric median by Weiszfeld's iteration, which initialises the SAE
decoder bias at the trainer's first step (multimodal_sae_tpu/ops/
geometric_median.py; reference sae_auto_interp/sae/utils.py:36-62)."""

from __future__ import annotations

import torch


def geometric_median(points: torch.Tensor, max_iter: int = 100, tol: float = 1e-5) -> torch.Tensor:
    """The geometric median of `points` (N, d), in fp32, on their device.

    The JAX package's loop step for step: start at the mean, reweight every
    point by its inverse distance to the guess (distances clamped at 1e-12,
    so a point on the guess cannot give inf), stop once a step moves the
    guess by less than `tol` or after `max_iter` steps.  A Python loop: each
    step reads one scalar back, and the trainer calls this once."""
    points = points.float()
    guess = points.mean(dim=0)
    for _ in range(max_iter):
        prev = guess
        norms = torch.linalg.vector_norm(points - guess, dim=1).clamp_min(1e-12)
        weights = 1.0 / norms
        weights = weights / weights.sum()
        guess = (weights[:, None] * points).sum(dim=0)
        if bool(torch.linalg.vector_norm(guess - prev) < tol):
            break
    return guess
