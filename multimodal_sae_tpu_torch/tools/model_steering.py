"""Single-feature steering:

    python -m multimodal_sae_tpu_torch.tools.model_steering --model <checkpoint> \\
        --sae-path <dir or org/name> -f <feature> -t "<prompt>" [-i <image>] [-k 10] [--pure-text]

The flags, defaults and printed sections of the JAX package's
`tools/model_steering.py`: two greedy generations of 512 tokens, the
original and one with the feature's latent clamped to `--clamp-value` at
the prefill (`clamp_features_max`), each printed under its heading.  The
subject (a local checkpoint directory) runs on the card in bf16 with flash
attention, as the steering CLI loads it: the prefill runs K3, the clamp K1
and K2's decode mode, the decode steps eager attention.  `steer` is the
core, on a loaded subject and SAE."""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, set_precision, setup
from ..features.steering import clamp_features_max, load_image
from ..interp_utils import load_single_sae
from ..launch.utils import load_subject_model, prepare_prompt_batch

MAX_NEW_TOKENS = 512
HEADINGS = (" ===========  Original ===========", " ===========  Steering ===========")


def parse_argument(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", "-m", type=str, default="llava-hf/llama3-llava-next-8b-hf",
                        help="The model name of your trained model")
    parser.add_argument("--image-path", "-i", type=str, default=None)
    parser.add_argument("--text", "-t", type=str, help="The prompt text")
    parser.add_argument("--sae-path", type=str, help="SAE path, hub or local")
    parser.add_argument("--module-name", type=str, default="model.layers.24")
    parser.add_argument("--clamp-value", "-k", type=float, default=10)
    parser.add_argument("--feature_idx", "-f", type=int, help="Feature to clamp")
    parser.add_argument("--pure-text", action="store_true", help="Raw prompt, no chat template")
    return parser.parse_args(argv)


def prompt_length(batch: dict) -> int:
    """The prompt's token count: the width of the batch's id rows."""
    ids = batch["input_ids"]
    return ids.shape[-1] if hasattr(ids, "shape") else len(ids[0])


def steer(model, sae, batch: dict, module_name: str, feature: int, clamp: float,
          max_new_tokens: int = MAX_NEW_TOKENS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(original, steered) new token ids, (B, max_new_tokens) each, on the
    model's device: a greedy `generate`, then one with `feature` clamped to
    `clamp` at the prefill only."""
    set_precision()
    start = prompt_length(batch)
    original = model.generate(batch, max_new_tokens=max_new_tokens)[:, start:]
    iv = {module_name: clamp_features_max(sae, feature, k=clamp)}
    steered = model.generate(batch, max_new_tokens=max_new_tokens, interventions=iv, intervene_prefill_only=True)
    return original, steered[:, start:]


def decode_first(tok, new_ids: torch.Tensor) -> str:
    """The first row's new ids as text, special tokens skipped."""
    return tok.batch_decode(np.asarray(new_ids.cpu()), skip_special_tokens=True)[0]


def main(argv=None, device: DeviceLike = None):
    args = parse_argument(argv)
    device = setup(device)
    sae = load_single_sae(args.sae_path, args.module_name, device=device)
    model, processor, tokenizer = load_subject_model(args.model, dtype=torch.bfloat16, flash_attention=True,
                                                     device=device)
    image = load_image(args.image_path) if args.image_path is not None else None
    text = args.text
    tok, _, batch = prepare_prompt_batch(
        model, processor, tokenizer, text, image, use_chat_template=not args.pure_text,
        raw_prompt=text if image is None else "<image>\n" + text,
    )
    original, steered = steer(model, sae, batch, args.module_name, args.feature_idx, args.clamp_value)
    print(HEADINGS[0])
    print(decode_first(tok, original))
    print(HEADINGS[1])
    print(decode_first(tok, steered))


if __name__ == "__main__":
    main()
