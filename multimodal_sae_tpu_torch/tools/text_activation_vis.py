"""HTML heatmap of the filtered features' activations over a text:

    python -m multimodal_sae_tpu_torch.tools.text_activation_vis --model-path <checkpoint> \\
        --sae-path <dir or org/name> --explanation-dir <dir> --text "<text>" --save-path <html> [--filters <json>]

The flags and output of the JAX package's `tools/text_activation_vis.py`:
the subject runs over the text, each hookpoint's SAE encodes it (top-k:
K1 on the card), and every feature that has an explanation gets a block of
tokens coloured by its activation, normalised to [0, 1].  The subject runs
on the card in bf16 with flash attention.  Where the JAX tool scatters the
top-k into a dense (tokens, latents) array, `feature_columns` builds only
the columns of the features written, with the same values.
`feature_activations` is the core, on a loaded subject and SAEs."""

from __future__ import annotations

import argparse
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..device import DeviceLike, set_precision, setup
from ..interp_utils import load_explanation, load_filter, load_saes
from ..launch.utils import load_subject_model

HTML_START = "<html><body>"
HTML_END = "</body></html>"


def parse_argument(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--explanation-dir", type=str)
    parser.add_argument("--model-path", type=str, help="The subject model path")
    parser.add_argument("--sae-path", type=str)
    parser.add_argument("--save-path", type=str, help="Output html path")
    parser.add_argument("--filters", type=str, default=None)
    parser.add_argument("--text", type=str, help="Text to visualize")
    return parser.parse_args(argv)


def activation_to_color(activation: float) -> str:
    return f"background-color: rgba(255, 0, 0, {activation});"


def generate_feature_html(feature_name, tokens, activations, explanation):
    activations = np.asarray(activations, dtype=np.float64)
    rng = activations.max() - activations.min()
    activations = (activations - activations.min()) / (rng if rng else 1.0)
    html_tokens = [
        f'<span style="{activation_to_color(float(act))}">{token}</span>'
        for token, act in zip(tokens, activations)
    ]
    styled_text = " ".join(html_tokens)
    return f"""
    <h2>{feature_name}</h2>
    <p>{explanation}</p>
    <p>{styled_text}</p>
    <hr>
    """


def feature_columns(vals: torch.Tensor, idx: torch.Tensor, features: Iterable[int]) -> torch.Tensor:
    """(tokens, features) activations of `features` from a top-k encoding
    (vals, idx), (tokens, k) each: a feature's value where a token selected
    it, else 0, as the dense scatter of the top-k gives.  A token selects a
    feature at most once, so each sum has one term."""
    feats = torch.as_tensor(np.asarray(list(features), dtype=np.int64), device=idx.device)
    hit = idx.long().unsqueeze(-1) == feats
    return torch.where(hit, vals.unsqueeze(-1), torch.zeros((), dtype=vals.dtype, device=vals.device)).sum(1)


@torch.no_grad()
def feature_activations(model, saes: Dict[str, object], ids: List[int],
                        features: Dict[str, List[int]]) -> Dict[str, np.ndarray]:
    """{hookpoint: (tokens, features) activations on the host} of
    `features[hookpoint]` on one row of token ids, each hookpoint encoded
    by its SAE."""
    set_precision()
    hiddens = model.capture({"input_ids": np.asarray([ids])}, list(saes))
    out = {}
    for module_path, h in hiddens.items():
        vals, idx = saes[module_path].encode(h[0])
        out[module_path] = feature_columns(vals, idx, features[module_path]).cpu().numpy()
    return out


def main(argv=None, device: DeviceLike = None):
    args = parse_argument(argv)
    device = setup(device)
    model, _, tokenizer = load_subject_model(args.model_path, dtype=torch.bfloat16, flash_attention=True,
                                             device=device)
    explanations = load_explanation(args.explanation_dir)
    filters = load_filter(args.filters) if args.filters else None
    submodule_dict = load_saes(args.sae_path, filters, device=device)

    ids = tokenizer(args.text)["input_ids"]
    tokens_str = [tokenizer.convert_tokens_to_string([tokenizer.convert_ids_to_tokens(t)]) for t in ids]
    # Only the features that have an explanation are written.
    written = {
        module_path: [int(i) for i in (filters[module_path] if filters is not None else range(sae.num_latents))
                      if f"{module_path}_feature{int(i)}" in explanations]
        for module_path, sae in submodule_dict.items()
    }
    activations = feature_activations(model, submodule_dict, ids, written)

    full_html = HTML_START
    for module_path, columns in activations.items():
        for j, i in enumerate(written[module_path]):
            name = f"{module_path}_feature{i}"
            full_html += generate_feature_html(name, tokens_str, columns[:, j], explanations[name])
    full_html += HTML_END
    with open(args.save_path, "w") as f:
        f.write(full_html)


if __name__ == "__main__":
    main()
