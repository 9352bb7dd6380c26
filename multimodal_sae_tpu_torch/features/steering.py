"""Feature steering (multimodal_sae_tpu/features/steering.py).

A clamp intervention replaces a layer's output with the SAE reconstruction
after setting one latent to a fixed value; `SteeringController` generates
the unsteered answer and, per feature, the steered one, with the
interventions at the prefill only (the reference's hook skips length-1
decode calls).  The features of a chunk ride the batch axis: row b of the
generate batch is steered by feature b.

The JAX package wraps the clamp in an `Intervention` so that its jitted
generate program is compiled once; here an intervention is a callable
`h -> h`.  Under `--dp N` the controller tops a ragged chunk up to a
multiple of N by repeating its last feature, as the JAX controller does,
and each replica's rows are clamped at their own features
(`BatchedClamp.rows`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import set_precision
from ..models.llama import InterventionFn
from ..parallel.data_parallel import replicas_of
from ..sae import Sae
from ..sae.model import decode as sae_decode, pre_acts as sae_pre_acts, select_topk

CLAMP_CHUNK = 4096
"""Tokens encoded, clamped, selected and decoded at a time: the fp32
latents of a chunk are 4,096 x 131,072 x 4 bytes = 2.1 GB, where a whole
steered image batch (8 rows of 2,341 tokens) would take 9.8 GB.  Tokens are
independent, so the output does not depend on the chunk."""


def clamp_hidden(
    sae: Sae, h: torch.Tensor, features: torch.Tensor, clamp: float, chunk: int = CLAMP_CHUNK
) -> torch.Tensor:
    """The body of the clamp interventions (the JAX package's `_clamp_iv` /
    `_clamp_batched_iv`): the SAE's pre-activations of h (B, S, D), row b's
    latent `features[b]` set to `clamp`, the top-k of the result decoded
    (K1 in the top-k and K2's decode mode on the card), cast to h's dtype.
    `features` is (B,) or a scalar for every row."""
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    feature_of_token = torch.as_tensor(features, device=h.device).long().expand(B).repeat_interleave(S)
    out = torch.empty_like(x)
    for t0 in range(0, B * S, chunk):
        latents = sae_pre_acts(sae.params, x[t0:t0 + chunk])
        rows = torch.arange(latents.shape[0], device=h.device)
        latents[rows, feature_of_token[t0:t0 + chunk]] = float(np.float32(clamp))
        top = select_topk(latents, sae.cfg.k)
        del latents
        out[t0:t0 + chunk] = sae_decode(sae.params, top.top_acts, top.top_indices).to(h.dtype)
    return out.view(B, S, D)


def clamp_features_max(sae: Sae, feature: int, k: float = 10) -> InterventionFn:
    """Intervention: clamp `feature`'s latent to `k` at every token, re-select
    the top-k, decode (reference steering.py:102-128)."""
    set_precision()
    return lambda h: clamp_hidden(sae, h, torch.tensor(int(feature)), k)


class BatchedClamp:
    """The batched clamp: row b of the hidden batch gets `features[b]`
    clamped to `k`.  `rows(start, end)` is the clamp of rows [start, end)
    alone, which a `--dp` replica applies to its share of the batch
    (parallel/data_parallel.py `rows_intervention`)."""

    def __init__(self, sae: Sae, features: torch.Tensor, k: float):
        self.sae, self.features, self.k = sae, features, k

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return clamp_hidden(self.sae, h, self.features, self.k)

    def rows(self, start: int, end: int) -> "BatchedClamp":
        return BatchedClamp(self.sae, self.features[start:end], self.k)


def clamp_features_max_batched(sae: Sae, features: Sequence[int], k: float = 10) -> InterventionFn:
    """Batched steering intervention: row b of the hidden batch gets
    `features[b]` clamped to `k`; per row the same as `clamp_features_max`.
    The prompt is shared, so F features steer in one generate call instead
    of the reference's one call per feature."""
    set_precision()
    return BatchedClamp(sae, torch.as_tensor(np.asarray(features, dtype=np.int64)), k)


class SteeringController:
    """Generates baseline vs per-feature clamped continuations (reference
    steering.py:13-100).

    Args:
        sae: the Sae to steer with.
        module_name: hookpoint, e.g. "model.layers.24".
        feature_idx: feature ids to steer (one generation each).
        model: LlavaNextModel / LlamaModel (generate API).
        processor: HF processor or tokenizer for chat templating and decode.
        prompt: user text.
        image_path: optional input image.
        k: clamp value (default 50).
        max_new_tokens: tokens generated per answer.
        feature_batch_size: features steered per generate call, on its batch
            axis (`clamp_features_max_batched`).
        generation_config: optional {"do_sample", "temperature", "top_p",
            "seed", "eos_token_id"} dict (the checkpoint's
            generation_config.json, attached by
            launch.utils.load_subject_model); greedy when absent.  The
            baseline and every steered chunk start from the same seed.
    """

    def __init__(
        self,
        sae: Sae,
        module_name: str,
        feature_idx: List[int],
        model,
        processor,
        prompt: str,
        image_path: Optional[str] = None,
        k: float = 50,
        max_new_tokens: int = 512,
        feature_batch_size: int = 1,
        generation_config: Optional[dict] = None,
    ):
        set_precision()
        self.sae = sae
        self.feature_idx = feature_idx
        self.model = model
        self.module_name = module_name
        self.processor = processor
        self.k = k
        self.max_new_tokens = max_new_tokens
        self.feature_batch_size = max(1, int(feature_batch_size))
        gen_cfg = generation_config or {}
        tokenizer = getattr(processor, "tokenizer", processor)
        self._sample_kwargs = {}
        if gen_cfg.get("do_sample"):
            # An explicit temperature of 0.0 is greedy intent, not 1.0; HF
            # generate rejects non-positive temperatures, and so does this.
            temperature = gen_cfg.get("temperature")
            temperature = 1.0 if temperature is None else float(temperature)
            if temperature <= 0.0:
                raise ValueError(
                    f"do_sample=True with temperature={temperature}; use "
                    "do_sample=False for greedy decoding (HF generate "
                    "rejects non-positive temperatures too)."
                )
            self._sample_kwargs = {
                "do_sample": True,
                "temperature": temperature,
                "top_p": gen_cfg.get("top_p"),
                "seed": int(gen_cfg.get("seed", 0)),
            }
        # Stop ids apply in either mode: the config's first, else the
        # tokenizer's.
        eos = gen_cfg.get("eos_token_id")
        if eos is None:
            eos = getattr(tokenizer, "eos_token_id", None)
        if eos is not None:
            self._sample_kwargs["eos_token_id"] = eos

        conversation = [{"role": "user", "content": [{"type": "text", "text": prompt}]}]
        image = None
        if image_path is not None:
            image = load_image(image_path)
            conversation[0]["content"].append({"type": "image"})
        templated = processor.apply_chat_template(conversation, add_generation_prompt=True, tokenize=False)
        # Plain tokenisation (default add_special_tokens), as the reference's
        # `processor(text=templated)`: a template that emits BOS and a
        # tokenizer that prepends one give the same duplicated BOS there.
        prompt_ids = tokenizer(templated)["input_ids"]
        if image is not None:
            self.batch = model.prepare_inputs(images=[image], prompt_ids=[prompt_ids])
        else:
            self.batch = {"input_ids": [prompt_ids]}

    def _decode_continuations(self, output) -> List[str]:
        ids = self.batch["input_ids"]
        prompt_len = len(ids[0]) if isinstance(ids, list) else np.asarray(ids).shape[-1]
        cont = output.cpu().numpy()[:, prompt_len:]
        tokenizer = getattr(self.processor, "tokenizer", self.processor)
        return tokenizer.batch_decode(cont, skip_special_tokens=True)

    def _replicate_batch(self, n: int) -> dict:
        """The single-prompt batch tiled to `n` rows.  List entries repeat
        per element and by reference, so rows share one pixel array and the
        tower runs once for them."""
        if n == 1:
            return self.batch
        out = {}
        for key, val in self.batch.items():
            if isinstance(val, list):
                out[key] = [v for v in val for _ in range(n)]
            else:
                out[key] = np.repeat(np.asarray(val), n, axis=0)
        return out

    def run(self) -> Dict[str, dict]:
        result_dict = {}
        output = self.model.generate(self.batch, max_new_tokens=self.max_new_tokens, **self._sample_kwargs)
        original_resps = self._decode_continuations(output)[0]

        try:
            from tqdm import tqdm

            pbar = tqdm(total=len(self.feature_idx), desc="Clamping...")
        except ImportError:
            pbar = None
        fbs = self.feature_batch_size
        # A `--dp N` generate splits its rows only when N divides them: a
        # ragged chunk is topped up with its last feature (JAX :236-257),
        # and zip() below drops the extra rows.
        dp = max(1, len(replicas_of(self.model)))
        for i in range(0, len(self.feature_idx), fbs):
            chunk = [int(f) for f in self.feature_idx[i:i + fbs]]
            run_chunk = chunk + [chunk[-1]] * (-len(chunk) % dp)
            iv = {self.module_name: clamp_features_max_batched(self.sae, run_chunk, k=self.k)}
            output = self.model.generate(
                self._replicate_batch(len(run_chunk)),
                max_new_tokens=self.max_new_tokens,
                interventions=iv,
                intervene_prefill_only=True,
                **self._sample_kwargs,
            )
            clamped = self._decode_continuations(output)
            for idx, clamped_resps in zip(chunk, clamped):
                result_dict[f"{self.module_name}_feature{idx}"] = {
                    "original_resps": original_resps,
                    "clamped_resps": clamped_resps,
                    "idx": idx,
                }
            if pbar:
                pbar.update(len(chunk))
        return result_dict


def load_image(path: str):
    """The image at `path` (PIL, imported here only)."""
    from PIL import Image

    return Image.open(path)
