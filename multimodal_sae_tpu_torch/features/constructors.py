"""Dense-example construction from sparse COO feature data
(multimodal_sae_tpu/features/constructors.py): sparse -> dense over the
active rows, fixed-stride windows ranked by their max (text), the average
over the base image's tokens with duplicate images dropped (images), and
random negative baselines.  Host numpy; the selections (a stable descending
argsort, seeded `np.random.default_rng` draws) equal the JAX package's."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import FeatureConfig
from .features import FeatureRecord, prepare_examples, prepare_image_examples
from .loader import BufferOutput


def _to_dense(tokens: np.ndarray, activations: np.ndarray, locations: np.ndarray):
    """COO → dense (rows_with_activity, seq) (reference constructors.py:11-24).

    Scatters straight into the compact active-row layout rather than a full
    (batch, seq) array: one feature typically touches a small fraction of the
    dataset rows, so zero-filling and window-pooling the whole batch wastes
    most of the work.  Row ids are bounded by the batch length, so the
    ascending-unique + inverse map is a counting LUT, not a sort.  Bitwise
    equal to the scatter-then-select formulation: `np.add.at` is unbuffered
    and processes entries in array order either way."""
    batch_len, seq_len = tokens.shape
    rows = locations[:, 0]
    uniq = np.nonzero(np.bincount(rows, minlength=batch_len))[0]
    compact = np.zeros(batch_len, dtype=np.intp)
    compact[uniq] = np.arange(len(uniq))
    dense = np.zeros((len(uniq), seq_len), dtype=activations.dtype)
    np.add.at(dense, (compact[rows], locations[:, 1]), activations)
    return tokens[uniq], dense


def _top_k_pools(
    dense_activations: np.ndarray,
    token_batches: np.ndarray,
    ctx_len: int,
    max_examples: int,
):
    """Window into ctx_len chunks, rank by per-window max
    (reference constructors.py:28-67)."""
    n, seq = dense_activations.shape
    n_windows = seq // ctx_len
    trimmed_acts = dense_activations[:, : n_windows * ctx_len]
    trimmed_toks = token_batches[:, : n_windows * ctx_len]
    activation_windows = trimmed_acts.reshape(-1, ctx_len)
    token_windows = trimmed_toks.reshape(-1, ctx_len)
    pools = activation_windows.max(axis=1)

    k = min(max_examples, int((pools != 0).sum()))
    # Descending sort == torch.topk ordering (reference constructors.py:61).
    top_indices = np.argsort(-pools, kind="stable")[:k]
    return token_windows[top_indices], activation_windows[top_indices]


def pool_max_activation_windows(
    record: FeatureRecord,
    buffer_output: BufferOutput,
    tokens: np.ndarray,
    cfg: FeatureConfig,
):
    """Fill record.examples with the top max-pooled ctx windows
    (reference constructors.py:70-85)."""
    token_batches, dense = _to_dense(
        np.asarray(tokens), buffer_output.activations, buffer_output.locations
    )
    token_windows, activation_windows = _top_k_pools(
        dense, token_batches, cfg.example_ctx_len, cfg.max_examples
    )
    record.examples = prepare_examples(token_windows, activation_windows)


# Image caches never exceed this many positions per image
# (reference constructors.py:102-105: "even llava-ov have less than 8000").
_FAKE_SEQ_LEN = 8000


def _dense_image_activations(buffer_output: BufferOutput, batch_size: int):
    dense = np.zeros((batch_size, _FAKE_SEQ_LEN), dtype=buffer_output.activations.dtype)
    loc = buffer_output.locations
    np.add.at(dense, (loc[:, 0], loc[:, 1]), buffer_output.activations)
    return dense


def pool_max_activations_windows_image(
    record: FeatureRecord,
    buffer_output: BufferOutput,
    tokens,
    cfg: FeatureConfig,
    processor=None,
    num_image_tokens: Optional[int] = None,
):
    """Image example construction (reference constructors.py:88-148): average
    the first `num_image_tokens` base-image positions per image, take the top
    max_examples (+50 then de-duplicated by dataset `id` because llava-next
    data repeats images), and build highlighted-image examples.

    `tokens` is the image dataset (len == number of cached images, column
    "image", optional column "id")."""
    if num_image_tokens is None:
        num_image_tokens = (
            getattr(processor, "num_image_tokens", 576) if processor is not None else 576
        )
    batch_size = len(tokens)
    dense = _dense_image_activations(buffer_output, batch_size)
    avg_pools = dense[:, :num_image_tokens].mean(axis=1)

    top_indices = np.argsort(-avg_pools, kind="stable")[
        : cfg.max_examples + 50
    ].tolist()

    features = getattr(tokens, "features", None) or getattr(tokens, "column_names", [])
    if "id" in features:
        image_ids = _select_column(tokens, top_indices, "id")
        seen = set()
        new_top_indices = []
        for idx, image_id in enumerate(image_ids):
            if image_id not in seen:
                new_top_indices.append(top_indices[idx])
                seen.add(image_id)
        if len(new_top_indices) < cfg.max_examples:
            new_top_indices += [new_top_indices[0]] * (
                cfg.max_examples - len(new_top_indices)
            )
        top_indices = new_top_indices[: cfg.max_examples]
    else:
        top_indices = top_indices[: cfg.max_examples]

    top_images = _select_column(tokens, top_indices, "image")
    fake_tokens = np.zeros((len(top_indices), _FAKE_SEQ_LEN))
    record.examples = prepare_image_examples(
        fake_tokens,
        dense[top_indices],
        top_images,
        processor,
        num_image_tokens=num_image_tokens,
    )


def random_activations_image(
    record: FeatureRecord,
    buffer_output: BufferOutput,
    tokens,
    cfg: FeatureConfig,
    processor=None,
    num_image_tokens: Optional[int] = None,
    seed: Optional[int] = None,
):
    """Random-image baseline (reference constructors.py:151-181)."""
    if num_image_tokens is None:
        num_image_tokens = (
            getattr(processor, "num_image_tokens", 576) if processor is not None else 576
        )
    batch_size = len(tokens)
    dense = _dense_image_activations(buffer_output, batch_size)
    rng = np.random.default_rng(seed)
    top_indices = rng.integers(0, batch_size, size=cfg.max_examples).tolist()
    top_images = _select_column(tokens, top_indices, "image")
    fake_tokens = np.zeros((len(top_indices), _FAKE_SEQ_LEN))
    record.examples = prepare_image_examples(
        fake_tokens,
        dense[top_indices],
        top_images,
        processor,
        num_image_tokens=num_image_tokens,
    )


def random_activation_windows(
    record: FeatureRecord,
    tokens: np.ndarray,
    buffer_output: BufferOutput,
    ctx_len: int,
    n_random: int,
    seed: int = 22,
):
    """Negative examples from rows where the feature never fired
    (reference constructors.py:184-209)."""
    rng = np.random.default_rng(seed)
    tokens = np.asarray(tokens)
    batch_size = tokens.shape[0]
    active_rows = np.unique(buffer_output.locations[:, 0])
    mask = np.ones(batch_size, dtype=bool)
    mask[active_rows] = False
    available = np.nonzero(mask)[0]
    selected = available[rng.permutation(len(available))[:n_random]]
    toks = tokens[selected, 10 : 10 + ctx_len]
    record.random_examples = prepare_examples(toks, np.zeros_like(toks))


def default_constructor(
    record: FeatureRecord,
    tokens: np.ndarray,
    buffer_output: BufferOutput,
    n_random: int,
    ctx_len: int,
    max_examples: int,
):
    """Max-pooled positives + random negatives (reference constructors.py:212-234)."""
    cfg = FeatureConfig(
        width=0, example_ctx_len=ctx_len, max_examples=max_examples
    )
    pool_max_activation_windows(record, buffer_output, tokens, cfg)
    random_activation_windows(record, tokens, buffer_output, ctx_len, n_random)


def _select_column(dataset, indices, column):
    """dataset.select(indices)[column] for HF datasets, plain indexing otherwise."""
    if hasattr(dataset, "select"):
        return dataset.select(indices=indices)[column]
    return [dataset[i][column] for i in indices]
