"""Feature statistics on the card (multimodal_sae_tpu/features/stats.py):
direct logit attribution, max-activating-token diversity, decoder cosine
similarity and decoder-space neighbours.

Two points where torch differs from jnp:
- `jnp.matmul` of a bf16 `W_U` with an fp32 `W_dec` promotes to fp32;
  `torch.matmul` refuses mixed dtypes, so both are cast to their promoted
  dtype first;
- `jnp.argsort(-x)` is stable (among equal values the lower index comes
  first), so the orders here come from `torch.sort(descending=True,
  stable=True)`; `torch.topk` does not promise that order.
fp32 products run with TF32 off.
"""

from __future__ import annotations

from collections import defaultdict
from math import floor
from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, set_precision
from .features import FeatureRecord


def _tensor(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


def _descending(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Indices of `x` sorted descending along `dim`, ties lower index first."""
    return torch.sort(x, dim=dim, descending=True, stable=True).indices


def logits(records: List[FeatureRecord], W_U, W_dec, k: int = 10, tokenizer=None, device: DeviceLike = None) -> List[List[str]]:
    """Top-k direct logit attribution `W_U @ W_dec[:, idx]` per record
    (reference stats.py:12-47); sets each record's `top_logits`.

    Args:
        W_U: (vocab, d) unembedding matrix.
        W_dec: (d, L) decoder matrix (feature columns).
    """
    dev = resolve_device(device)
    set_precision()
    W_U, W_dec = _tensor(W_U, dev), _tensor(W_dec, dev)
    dtype = torch.promote_types(W_U.dtype, W_dec.dtype)
    feature_indices = torch.tensor([record.feature.feature_index for record in records], device=dev)
    narrowed_logits = torch.matmul(W_U.to(dtype), W_dec[:, feature_indices].to(dtype))
    top_logits = _descending(narrowed_logits, dim=0)[:k]  # (k, n_records)
    per_record = top_logits.T.cpu().numpy()

    decoded_top_logits = []
    for record_index in range(len(records)):
        decoded = tokenizer.batch_decode(per_record[record_index][:, None])
        decoded_top_logits.append(decoded)
        records[record_index].top_logits = decoded
    return decoded_top_logits


def unigram(record: FeatureRecord, k: int = 10, threshold: float = 0.0, negative_shift: int = 0):
    """Max-activating-token diversity check (reference stats.py:50-73), on
    the host.  `threshold` is the fraction of examples to inspect; the
    reference's default 0.0 inspects none and returns (set(), nan)."""
    avg_nonzero = []
    top_tokens = []
    n_examples = floor(len(record.examples) * threshold)
    for example in record.examples[:n_examples]:
        acts = np.asarray(example.activations)
        avg_nonzero.append(int(np.count_nonzero(acts)))
        index = int(np.argmax(acts)) - negative_shift
        if index < 0:
            continue
        top_tokens.append(int(np.asarray(example.tokens)[index]))

    if len(set(top_tokens)) < k:
        return set(top_tokens), float(np.mean(avg_nonzero))
    return -1, float(np.mean(avg_nonzero))


def cos(matrix, selected_features=(0,), device: DeviceLike = None) -> torch.Tensor:
    """Column-cosine similarity of the selected columns against all columns
    (reference stats.py:76-85); `matrix` is (d, L)."""
    dev = resolve_device(device)
    set_precision()
    matrix = _tensor(matrix, dev)
    sel = torch.as_tensor(np.asarray(list(selected_features), dtype=np.int64), device=dev)
    a = matrix[:, sel]
    a = a / (torch.linalg.norm(a, dim=0, keepdim=True) + 1e-12)
    b = matrix / (torch.linalg.norm(matrix, dim=0, keepdim=True) + 1e-12)
    return a.T @ b


def get_neighbors(submodule_dict: Dict[str, object], feature_filter: Dict, k: int = 10, device: DeviceLike = None):
    """Top-k decoder-space neighbours per selected feature
    (reference stats.py:88-120); `submodule_dict` maps hookpoint -> Sae.

    As in the reference, entries are keyed by position in the filter, and
    the first neighbour is dropped as the feature itself (with duplicated
    decoder rows a tie could drop a real neighbour instead)."""
    dev = resolve_device(device)
    neighbors_dict = defaultdict(dict)
    per_layer_features = {}

    for module_path, sae in submodule_dict.items():
        selected_features = feature_filter.get(module_path, False)
        if selected_features is False or len(selected_features) == 0:
            continue
        # (L, d) decoder rows -> the column layout (d, L).
        W_D = sae.params["W_dec"].T
        cos_sim = cos(W_D, selected_features=selected_features, device=dev)
        order = _descending(cos_sim, dim=-1)[:, :k]
        values = torch.gather(cos_sim, -1, order)
        order_np, values_np = order.cpu().numpy(), values.cpu().numpy()
        for i in range(order_np.shape[0]):
            neighbors_dict[module_path][i] = {
                "indices": order_np[i].tolist()[1:],
                "values": values_np[i].tolist()[1:],
            }
        per_layer_features[module_path] = np.unique(order_np).tolist()

    return neighbors_dict, per_layer_features
