"""SAE-splice forward helpers (multimodal_sae_tpu/features/patching/utils.py).

The splice is an intervention that replaces a layer's output with its SAE
reconstruction, optionally with one feature ablated.  The gradient with
respect to the spliced output comes from a zero `delta` added at the
splice: a leaf tensor that requires grad, differentiated with
`torch.autograd.grad`, as the JAX package takes `jax.vjp` at zero."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ...sae import Sae, decode, pre_acts, select_topk


def get_logit_diff(logits: torch.Tensor, answer_token_indices: torch.Tensor) -> torch.Tensor:
    """Final-token correct-vs-baseline logit margin, averaged over rows.
    answer_token_indices: (B, 2)."""
    if logits.dim() == 3:
        logits = logits[:, -1, :]
    answers = answer_token_indices.to(device=logits.device, dtype=torch.long)
    correct = logits.gather(1, answers[:, 0:1])
    incorrect = logits.gather(1, answers[:, 1:2])
    return (correct - incorrect).mean()


def sae_splice_intervention(sae: Sae, off_feature: Optional[int] = None) -> Callable:
    """Intervention replacing a layer output with its SAE reconstruction,
    with latent `off_feature` zeroed before the top-k when given.

    Differentiable in h: below another splice (the general path over several
    hookpoints) the gradient runs back through the decode's values (K2's
    dvals mode on CUDA), the top-k's selected values and the encoder
    product.  The zeroing is out of place, since the ReLU's backward reads
    its output, and gives the reference's `latents * mask` bit for bit
    (post-ReLU latents are finite and >= 0)."""
    params, k = sae.params, sae.cfg.k

    def intervention(h: torch.Tensor) -> torch.Tensor:
        latents = pre_acts(params, h.reshape(-1, h.shape[-1]))
        if off_feature is not None:
            latents = latents.index_fill(1, torch.tensor([off_feature], device=latents.device), 0.0)
        top_acts, top_indices = select_topk(latents, k)
        return decode(params, top_acts, top_indices).reshape(h.shape).to(h.dtype)

    return intervention


def spliced_forward_with_delta(
    model,
    batch: dict,
    sae_dict: Dict[str, Sae],
    deltas: Dict[str, torch.Tensor],
    off_feature: Optional[int] = None,
):
    """Forward with SAE splices, each splice output plus `deltas[name]`.
    Returns (logits, {name: spliced output including its delta}); the
    gradient of a metric of the logits with respect to the deltas is the
    gradient at the splice."""
    interventions = {}
    for name, sae in sae_dict.items():
        base = sae_splice_intervention(sae, off_feature)

        def iv(h, base=base, delta=deltas[name]):
            return base(h) + delta.to(h.dtype)

        interventions[name] = iv
    out = model.forward(batch, capture=tuple(sae_dict), interventions=interventions)
    return out["logits"], out["captured"]
