"""Probe which features activate on one input:

    python -m multimodal_sae_tpu_torch.tools.probe_activations --model <checkpoint> \\
        --sae-path <dir or org/name> [-t "<text>"] [-i <image>] [-k 10] [--interval 1-10] [-s <dir>]

The flags, defaults and outputs of the JAX package's
`tools/probe_activations.py`: the SAE's pre-activations at the hookpoint,
averaged over the tokens (the leading BOS skipped on an image-only LLaMA
input), the features ranked by that mean within `--interval` (else the top
`--top-k`), `{save_to}/filters.json`, and with an image one PNG a feature
(`images/feat_{i}.png`: the first 576 positions as a 24 x 24 grid,
upsampled over the image resized to 336 x 336).  The subject runs on the
card in bf16 with flash attention; the mean is taken there, and only the
mean and the chosen features' columns come to the host.  `probe` is the
core, on a loaded subject and SAE."""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, set_precision, setup
from ..features.features import upsample_mask
from ..features.steering import load_image
from ..interp_utils import load_single_sae
from ..launch.utils import load_subject_model, prepare_prompt_batch

BASE_IMG_TOKENS, PATCH_SIZE, IMAGE_SIZE = 576, 24, 336


def parse_argument(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", "-m", type=str, default="llava-hf/llama3-llava-next-8b-hf")
    parser.add_argument("--sae-path", type=str)
    parser.add_argument("--module-name", type=str, default="model.layers.24")
    parser.add_argument("--image-path", "-i", type=str, default=None)
    parser.add_argument("--text", "-t", type=str, default=None)
    parser.add_argument("--top-k", "-k", type=int, default=10)
    parser.add_argument("--interval", type=str, default=None, help="e.g. 1-10 probes features ranked 1..10")
    parser.add_argument("--save-to", "-s", type=str, default="./results/probe_activations")
    return parser.parse_args(argv)


@torch.no_grad()
def probe(model, sae, batch: dict, module_name: str, interval: Sequence[int],
          skip_bos: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(features, activations, mean): the features ranked
    `interval[0]:interval[1]` by their mean pre-activation over the first
    row's tokens (`np.argsort(-mean)`, as the JAX tool ranks them), their
    pre-activations (features, tokens) and the mean (num_latents,), all on
    the host.  `skip_bos` drops the first token."""
    set_precision()
    hidden = model.capture(batch, [module_name])[module_name][0]
    if skip_bos:
        hidden = hidden[1:]
    latents = sae.pre_acts(hidden)
    mean = latents.mean(dim=0).cpu().numpy()
    features = np.argsort(-mean)[: interval[1]][interval[0]:]
    activations = latents[:, torch.as_tensor(features, device=latents.device)].T.cpu().numpy()
    return features, activations, mean


def highlight_images(image, activations: np.ndarray):
    """One PIL image a feature: the first 576 positions of its activations
    as a 24 x 24 mask over `image` resized to 336 x 336 (the rest black)."""
    from PIL import Image

    background = Image.new("L", (IMAGE_SIZE, IMAGE_SIZE), 0).convert("RGB")
    resized = image.resize((IMAGE_SIZE, IMAGE_SIZE))
    masks = [upsample_mask(acts[:BASE_IMG_TOKENS].reshape(PATCH_SIZE, PATCH_SIZE), (IMAGE_SIZE, IMAGE_SIZE))
             for acts in activations]
    return [Image.composite(background, resized, mask).convert("RGB") for mask in masks]


def main(argv=None, device: DeviceLike = None):
    args = parse_argument(argv)
    device = setup(device)
    sae = load_single_sae(args.sae_path, args.module_name, device=device)
    model, processor, tokenizer = load_subject_model(args.model, dtype=torch.bfloat16, flash_attention=True,
                                                     device=device)
    image = load_image(args.image_path) if args.image_path is not None else None
    text: Optional[str] = args.text
    assert image is not None or text is not None, "Image and text can not both be None"
    interval = [int(i) for i in args.interval.split("-")] if args.interval else [0, args.top_k]
    tok, _, batch = prepare_prompt_batch(model, processor, tokenizer, text, image,
                                         use_chat_template=text is not None, raw_prompt="<image>")
    # The leading BOS is skipped on image-only LLaMA inputs.
    skip_bos = text is None and "llama" in getattr(tok, "name_or_path", "")
    features, activations, _ = probe(model, sae, batch, args.module_name, interval, skip_bos)

    os.makedirs(args.save_to, exist_ok=True)
    if image is not None:
        image_dir = os.path.join(args.save_to, "images")
        os.makedirs(image_dir, exist_ok=True)
        for idx, im in zip(features, highlight_images(image, activations)):
            im.save(os.path.join(image_dir, f"feat_{idx}.png"))
    with open(os.path.join(args.save_to, "filters.json"), "w") as f:
        json.dump({args.module_name: features.tolist()}, f)


if __name__ == "__main__":
    main()
