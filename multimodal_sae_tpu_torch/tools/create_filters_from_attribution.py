"""Feature filters and saliency pictures from an attribution file:

    python -m multimodal_sae_tpu_torch.tools.create_filters_from_attribution \\
        --attribution-path <file.safetensors> --probing-data <probe.json> --tokenizer <checkpoint> \\
        [--filters-path ./filters] [-k 50] [--pool avg|max] [--image-only]

The flags, defaults and outputs of the JAX package's
`tools/create_filters_from_attribution.py`: each hookpoint's (features,
tokens) attribution map is pooled over the image span and over the text
after it, the top `-k` features of each are the filter
(`{filters_path}/filters_top_{k}_{probe name}.json`), the text features'
saliency is written as `{module}_activations.html` in the working
directory, and the image features' as `top_{rank}_feature_{i}.png` (the
base 24 x 24 grid over the probe image resized to 336 x 336) in the
directory named after the attribution file.  A host program: the ranking
is numpy's, as in the JAX tool.  `create_filters` is the core, on the maps
and the probe's tokens."""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..features.features import upsample_mask
from ..interp_utils import get_llava_image_pos, load_tokenizer

EOT_MARKER = "<|eot_id|>"
BASE_IMG_TOKENS, PATCH_SIZE, IMAGE_SIZE = 576, 24, 336


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--filters-path", type=str, default="./filters")
    parser.add_argument("--attribution-path", type=str, default="./attribution_cache")
    parser.add_argument("--top_k", "-k", default=50, type=int)
    parser.add_argument("--pool", default="avg", choices=["max", "avg"])
    parser.add_argument("--image-only", action="store_true", default=False)
    parser.add_argument("--probing-data", type=str)
    parser.add_argument("--tokenizer", type=str, default="llava-hf/llama3-llava-next-8b-hf")
    return parser.parse_args(argv)


def text_saliency_html(text_act: np.ndarray, features: Sequence[int], tokens: Sequence[str]) -> str:
    """Each feature's clipped, min-max scaled text saliency as coloured
    token spans."""
    html = ""
    for i in features:
        acts = np.clip(text_act[i, :], 0, None)
        rng = acts.max() - acts.min() + 1e-5
        acts = (acts - acts.min()) / rng
        html += f"<p>feature_{i}: </p>"
        for idx, token in enumerate(tokens):
            c = float(acts[idx])
            color = f"rgb(255, {int(255 * (1 - c))}, {int(255 * (1 - c))})"
            html += f"<span style='background-color: {color}; opacity: 0.8;'>{token}</span>"
        html += "<br>"
    return html


def create_filters(
    attribution: Dict[str, np.ndarray],
    tokens: Sequence[int],
    tokens_str: Sequence[str],
    image_token: int,
    top_k: int = 50,
    pool: str = "avg",
    image_only: bool = False,
) -> Tuple[Dict[str, List[int]], Dict[str, str], Dict[str, List[Tuple[int, np.ndarray]]]]:
    """(filters, html, grids) of the attribution maps {hookpoint:
    (features, tokens)}, whose token axis is the probe's ids without BOS
    (`tokens`, `tokens_str`) with its image token expanded: per hookpoint
    the top `top_k` image and text features (image first), the text
    saliency HTML, and each image feature's (feature, 24 x 24 grid of its
    clipped saliency over the first 576 image positions)."""
    prev, after = get_llava_image_pos(tokens, image_token)
    completion_tokens = list(tokens_str[after:])
    # One condition for both the token list and the activation columns, so
    # that a prompt with an end-of-turn marker before the image (a system
    # turn) keeps the two the same length.
    trim_eot = EOT_MARKER in completion_tokens
    if trim_eot:
        completion_tokens = completion_tokens[:-4]
    reduce = (lambda x: x.mean(axis=1)) if pool == "avg" else (lambda x: x.max(axis=1))
    filters, html, grids = {}, {}, {}
    for module_name, attribution_act in attribution.items():
        attribution_act = np.asarray(attribution_act)
        image_act = attribution_act[:, prev:after]
        text_act = attribution_act[:, after:]
        if trim_eot:
            text_act = text_act[:, :-4]
        image_top_k = np.argsort(-reduce(image_act))[:top_k].tolist()
        text_top_k = np.argsort(-reduce(text_act))[:top_k].tolist()
        filters[module_name] = image_top_k if image_only else image_top_k + text_top_k
        html[module_name] = text_saliency_html(text_act, text_top_k, completion_tokens)
        grids[module_name] = [
            (i, np.clip(attribution_act[i, prev:prev + BASE_IMG_TOKENS], 0, None).reshape(PATCH_SIZE, PATCH_SIZE))
            for i in image_top_k
        ]
    return filters, html, grids


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    from ..utils.safetensors_io import load_file

    # In name order, as `safetensors.numpy.load_file` returns them.
    loaded = load_file(args.attribution_path)
    attribution = {name: loaded[name].numpy() for name in sorted(loaded)}
    tokenizer = load_tokenizer(args.tokenizer)
    with open(args.probing_data, "r") as f:
        probing_data = json.load(f)[0]
    image = Image.open(probing_data["image"])
    tokens = tokenizer(probing_data["prompt"])["input_ids"][1:]
    tokens_str = [tokenizer.convert_tokens_to_string([tokenizer.convert_ids_to_tokens(t)]) for t in tokens]
    image_token = tokenizer.convert_tokens_to_ids("<image>")
    filters, html, grids = create_filters(attribution, tokens, tokens_str, image_token, args.top_k, args.pool,
                                          args.image_only)

    save_dir = args.attribution_path.rsplit(".", 1)[0]
    os.makedirs(save_dir, exist_ok=True)
    os.makedirs(args.filters_path, exist_ok=True)
    background = Image.new("L", (IMAGE_SIZE, IMAGE_SIZE), 0).convert("RGB")
    resized = image.resize((IMAGE_SIZE, IMAGE_SIZE))
    for module_name in filters:
        with open(f"{module_name}_activations.html", "w") as file:
            file.write(html[module_name])
        for rank, (i, grid) in enumerate(grids[module_name]):
            mask = upsample_mask(grid, (IMAGE_SIZE, IMAGE_SIZE))
            Image.composite(background, resized, mask).convert("RGB").save(
                os.path.join(save_dir, f"top_{rank}_feature_{i}.png"))

    name = f"filters_top_{args.top_k}_{args.probing_data.split('/')[-1].split('.')[0]}.json"
    with open(os.path.join(args.filters_path, name), "w") as f:
        json.dump(filters, f, indent=4)


if __name__ == "__main__":
    main()
