"""Training and caching datasets (copies of `chunk_and_tokenize`,
`process_mm_data` and `MemmapDataset` from multimodal_sae_tpu/train/data.py).  Host-side;
`datasets` and `transformers` objects come in from the caller."""

from __future__ import annotations

from typing import Optional

import numpy as np


def chunk_and_tokenize(
    data,
    tokenizer,
    *,
    format: str = "numpy",
    num_proc: int = 1,
    text_key: str = "text",
    max_seq_len: int = 2048,
    return_final_batch: bool = False,
    load_from_cache_file: bool = True,
):
    """GPT-style concat-with-EOS chunking to fixed `max_seq_len`
    (reference train/sae/sae/data.py:16-100): documents are joined with the
    EOS separator (the stream starts with one), split into exact-length
    chunks via overflow tokens, and the final ragged chunk is dropped unless
    `return_final_batch`.

    The tokenizer-call sequence (single joined string, truncation with
    `return_overflowing_tokens`, then re-chunking the overflow list) is
    pinned by design: chunk boundaries feed directly into the cache
    bit-parity guarantee, so both packages make the same calls."""

    def _tokenize_fn(x: dict):
        chunk_size = min(tokenizer.model_max_length, max_seq_len)
        sep = tokenizer.eos_token or "<|endoftext|>"
        joined_text = sep.join([""] + x[text_key])
        output = tokenizer(
            joined_text,
            max_length=chunk_size,
            return_attention_mask=False,
            return_overflowing_tokens=True,
            truncation=True,
        )

        if overflow := output.pop("overflowing_tokens", None):
            # A fast tokenizer would nest the overflow per chunk itself; the
            # flat-int shape here means we re-chunk the overflow by hand, so
            # assert we really got the slow-tokenizer layout.
            assert isinstance(output["input_ids"][0], int)
            chunks = [output["input_ids"]]
            chunks += [
                overflow[i : i + chunk_size]
                for i in range(0, len(overflow), chunk_size)
            ]
            output = {"input_ids": chunks}

        if not return_final_batch:
            output = {k: v[:-1] for k, v in output.items()}

        if len(output["input_ids"]) == 0:
            raise ValueError(
                f"chunk_and_tokenize produced zero complete {chunk_size}-token"
                " chunks; pass return_final_batch=True to keep the ragged"
                " tail, or tokenize a larger corpus."
            )
        return output

    data = data.map(
        _tokenize_fn,
        batched=True,
        batch_size=2048,
        num_proc=num_proc if num_proc > 1 else None,
        remove_columns=get_columns_all_equal(data),
        load_from_cache_file=load_from_cache_file,
    )
    return data.with_format(format, columns=["input_ids"])


def process_mm_data(data, tokenizer):
    """LLaVA "conversations" (from/value turns) -> chat-template
    `input_ids`, keeping the `image` column (reference
    train/sae/sae/data.py:103-142).  "human" turns become "user", "gpt"
    turns "assistant", any other speaker "system"; other keys of a turn pass
    through.  The dataset comes back unformatted: the caller formats the
    ids (numpy formatting would turn the images into arrays)."""
    roles = {"human": "user", "gpt": "assistant"}

    def _remap_turn(turn: dict) -> dict:
        out = {}
        for key, content in turn.items():
            if key == "from":
                out["role"] = roles.get(content, "system")
            elif key == "value":
                out["content"] = content
            else:
                out[key] = content
        return out

    def _tokenize_fn(x: dict):
        new_conv = [_remap_turn(t) for t in x["conversations"]]
        input_ids = tokenizer.apply_chat_template(new_conv, return_tensors="np", add_generation_prompt=False)
        return {"input_ids": input_ids}

    remove_columns = [c for c in get_columns_all_equal(data) if c not in ("image", "input_ids")]
    return data.map(_tokenize_fn, remove_columns=remove_columns)


def get_columns_all_equal(dataset) -> list:
    """Columns of a Dataset/DatasetDict, asserting split agreement
    (reference data.py:145-164)."""
    column_names = dataset.column_names
    if not isinstance(column_names, dict):
        return column_names
    distinct = {tuple(cols) for cols in column_names.values()}
    if len(distinct) != 1:
        raise ValueError("All splits must have the same columns")
    return list(distinct.pop())


class MemmapDataset:
    """Rows of `ctx_len` token ids from a memory-mapped token file
    (reference data.py:167-199).  `dtype` defaults to the reference's
    uint16, which cannot hold ids of a vocabulary above 65,536 (LLaMA-3 has
    128,256): write such files as uint32 and pass `dtype=np.uint32`."""

    def __init__(self, data_path: str, ctx_len: int, max_examples: Optional[int] = None, dtype=np.uint16):
        mmap = np.memmap(data_path, dtype=dtype, mode="r").reshape(-1, ctx_len)
        self.mmap = mmap[:max_examples]

    def __len__(self):
        return len(self.mmap)

    def __getitem__(self, idx):
        return dict(input_ids=self.mmap[idx].astype(np.int64))

    def select(self, rng: range) -> "MemmapDataset":
        out = MemmapDataset.__new__(MemmapDataset)
        out.mmap = self.mmap[rng.start : rng.stop]
        return out

    def shard(self, num_shards: int, shard_id: int) -> "MemmapDataset":
        out = MemmapDataset.__new__(MemmapDataset)
        out.mmap = np.array_split(self.mmap, num_shards)[shard_id]
        return out
