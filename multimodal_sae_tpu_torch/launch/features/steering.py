"""Steering CLI:

    python -m multimodal_sae_tpu_torch.launch.features.steering --model <checkpoint> \\
        --text <prompt> --sae-path <dir or org/name> --filters <filters.json> [--image-path <image>] ...

The same flags and defaults as `python -m
multimodal_sae_tpu.launch.features.steering` (reference
launch/features/steering.py:53-113): every filtered feature of each
hookpoint gets a clamped generation, `--feature-batch-size` of them per
generate call, and one `{module}.json` of original and steered answers is
written per hookpoint.  The subject (a local checkpoint directory) and the
SAEs run on the CUDA card; under `torchrun --nproc_per_node N` each rank
steers its `np.array_split` share of each hookpoint's features and rank 0
writes the merged json.  `--load-in-8bit`, `--int8-matmul` and
`--int8-vision` quantise the subject (models/quant.py).  `--tp N` shards
the subject over each group of N consecutive ranks (the features are split
over the groups); `--dp N` splits each generate batch and its KV cache over
N copies of the subject in one process (parallel/).  With bf16 weights (and with a
quantised subject, which computes in bf16) the prefill runs kernel K3;
K3 takes bf16 only, so other dtypes run eager attention."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ...device import DeviceLike, setup
from ...features.steering import SteeringController
from ...interp_utils import load_filter, load_saes
from ...parallel import gather_objects, initialize_distributed
from ...parallel.tensor_parallel import replicate_saes
from ..utils import load_subject_model, shard_info, validate_hookpoints, writes_outputs


def parse_argument(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", "-m", type=str, default="llava-hf/llama3-llava-next-8b-hf",
                        help="The model name of your trained model")
    parser.add_argument("--image-path", "-i", type=str, default=None)
    parser.add_argument("--text", "-t", type=str, required=True, help="The prompt text")
    parser.add_argument("--sae-path", type=str, required=True, help="SAE path, hub or local")
    parser.add_argument("--filters", type=str, required=True,
                        help="The filters json path (which features to steer)")
    parser.add_argument("--clamp-value", "-k", type=float, default=50)
    parser.add_argument("--save-dir", "-s", default="./results/steering")
    parser.add_argument(
        "--feature-batch-size", type=int, default=64,
        help="Features steered per generate call, on its batch axis (the prompt is "
        "shared). Batched rows compute the same math as sequential ones, but the "
        "reduction order varies with the batch shape, so a long greedy answer can "
        "diverge after a near-tie argmax; set 1 for exactly sequential behaviour.",
    )
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument(
        "--sampling", choices=["auto", "greedy", "sample"], default="auto",
        help="auto: honor the checkpoint's generation_config.json; greedy: force "
        "argmax decoding; sample: force sampling with the config's (or default) "
        "temperature/top_p.",
    )
    parser.add_argument("--seed", type=int, default=0, help="Sampling seed")
    parser.add_argument("--dtype", choices=["bfloat16", "float32", "float16"], default="bfloat16",
                        help="Subject model dtype")
    parser.add_argument("--load-in-8bit", action="store_true",
                        help="Int8-quantise the frozen subject (halves its memory; models/quant.py)")
    parser.add_argument("--int8-matmul", action="store_true",
                        help="W8A8 products (int8 x int8 -> int32) for the quantised subject's language model "
                        "(implies --load-in-8bit)")
    parser.add_argument("--int8-vision", action="store_true",
                        help="W8A8 products for the quantised CLIP tower")
    parser.add_argument("--tp", type=int, default=0,
                        help="Tensor-parallel degree: shard the subject over each group of this many consecutive "
                        "torchrun ranks")
    parser.add_argument("--dp", type=int, default=0,
                        help="In-process data parallelism: copies of the subject on this many local cards, each "
                        "generating its rows of a batch")
    return parser.parse_args(argv)


def main(argv=None, device: DeviceLike = None):
    args = parse_argument(argv)
    device = setup(device)
    initialize_distributed(device)
    quantized = args.load_in_8bit or args.int8_matmul
    model, processor, tokenizer = load_subject_model(
        args.model, dtype=getattr(torch, args.dtype), flash_attention=args.dtype == "bfloat16" or quantized,
        device=device, load_in_8bit=args.load_in_8bit, int8_matmul=args.int8_matmul, int8_vision=args.int8_vision,
        tp=args.tp, dp=args.dp,
    )
    rank, world = shard_info()
    if processor is None:  # text-only subject model
        processor = tokenizer
    filters = load_filter(args.filters)
    sae_dict = load_saes(args.sae_path, filters, device=device, decoder=True)
    replicate_saes(model, sae_dict.values())
    # A hookpoint the subject does not have would leave the clamp unapplied
    # and label unsteered answers as steered.
    validate_hookpoints(model, list(sae_dict))

    gen_cfg = dict(getattr(model, "generation_config", None) or {})
    if args.sampling == "greedy":
        gen_cfg["do_sample"] = False
    elif args.sampling == "sample":
        gen_cfg["do_sample"] = True
    gen_cfg["seed"] = args.seed

    for module_name, sae in sae_dict.items():
        feature_idx = np.array_split(filters[module_name], world)[rank].tolist()
        controller = SteeringController(
            sae=sae,
            module_name=module_name,
            feature_idx=feature_idx,
            prompt=args.text,
            model=model,
            processor=processor,
            image_path=args.image_path,
            k=args.clamp_value,
            max_new_tokens=args.max_new_tokens,
            feature_batch_size=args.feature_batch_size,
            generation_config=gen_cfg,
        )
        # One merged json per hookpoint on rank 0 (reference gather_object,
        # launch/features/steering.py:92-106): the shards' feature keys are
        # disjoint, so a dict union in rank order reassembles them; under
        # --tp each TP group's first rank speaks for the group.
        gathered = gather_objects((writes_outputs(), controller.run()))
        if gathered is None:
            continue
        merged = {}
        for writer, part in gathered:
            if writer:
                merged.update(part)
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, f"{module_name}.json"), "w", encoding="utf-8") as f:
            json.dump(merged, f, indent=4, ensure_ascii=False)


if __name__ == "__main__":
    main()
