"""Multimodal training collator (multimodal_sae_tpu/train/collator.py;
reference train/sae/sae/trainer.py:31-64, `DataCollatorForImage`): rows of
chat-template ids with one un-expanded `<image>` placeholder and an image
become a batch of padded ids, an attention mask and the images, which the
LLaVA subject's `capture` prepares (host only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np


@dataclass
class DataCollatorForImage:
    tokenizer: object

    def pad_sequence(self, input_ids, padding_value: int) -> np.ndarray:
        """Pad ragged rows to the longest; left padding (the tokenizer's
        `padding_side`) by flipping, right-padding and flipping back, as the
        reference does."""
        left = getattr(self.tokenizer, "padding_side", "right") == "left"
        rows = [np.asarray(r).reshape(-1) for r in input_ids]
        if left:
            rows = [r[::-1] for r in rows]
        out = np.full((len(rows), max(len(r) for r in rows)), padding_value, dtype=np.int64)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        if left:
            out = out[:, ::-1].copy()
        return out

    def __call__(self, instances: Sequence[Dict]) -> Dict:
        images = []
        for instance in instances:
            im = instance.get("image")
            if isinstance(im, (list, tuple)):
                im = im[0] if im else None
            images.append(im.convert("RGB") if im is not None and hasattr(im, "convert") else im)

        max_length = getattr(self.tokenizer, "model_max_length", 10**9)
        input_ids = [np.asarray(instance["input_ids"]).reshape(-1)[:max_length] for instance in instances]
        pad_id = self.tokenizer.pad_token_id
        if pad_id is None:
            pad_id = self.tokenizer.eos_token_id
        ids = self.pad_sequence(input_ids, padding_value=pad_id)
        # The mask comes from the true row lengths, not from `ids != pad_id`:
        # with a pad-less Llama-3 tokenizer the pad is EOS, and a value
        # compare would mask every real EOS / end-of-turn token of the
        # conversation out of the subject forward.
        lengths = np.array([len(r) for r in input_ids])
        pos = np.arange(ids.shape[1])
        if getattr(self.tokenizer, "padding_side", "right") == "left":
            attention_mask = (pos[None, :] >= ids.shape[1] - lengths[:, None]).astype(np.int64)
        else:
            attention_mask = (pos[None, :] < lengths[:, None]).astype(np.int64)
        return dict(images=images, input_ids=ids, attention_mask=attention_mask)
