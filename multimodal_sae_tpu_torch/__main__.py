"""SAE training CLI:

    python -m multimodal_sae_tpu_torch <model> <dataset> [--hookpoints ...] ...

The flags of `python -m multimodal_sae_tpu` (reference
train/sae/sae/__main__.py:25-181, console script `sae`).  The subject is
`synthetic://dM,L,V` or a local plain-LLaMA checkpoint directory; the
dataset a `.bin` token file (uint16, as the reference writes it), a local
`Dataset.save_to_disk` directory or a hub name.  One process trains on the
CUDA card; `run(device=...)` names another device (the tests pass "cpu").
--tp, --dp, --load_in_8bit, --int8_*, --mm_data and --distribute_modules are
refused until their slices are ported (ROADMAP.md §1)."""

from __future__ import annotations

from typing import Optional, Sequence

from .config import RunConfig
from .device import DeviceLike, setup
from .launch.utils import load_any_dataset, load_subject_or_synthetic
from .train import MemmapDataset, SaeTrainer, chunk_and_tokenize
from .utils.cli import parse_dataclass


def load_artifacts(args: RunConfig, device: DeviceLike = None):
    """The frozen subject and the training dataset (reference
    __main__.py:66-140): (model, dataset, tokenizer)."""
    if args.mm_data:
        raise NotImplementedError("--mm_data is not ported yet: ROADMAP.md §1, LLaVA-NeXT, CLIP and the image cache")
    model, _, tokenizer = load_subject_or_synthetic(args, device=device)

    if args.dataset.endswith(".bin"):
        dataset = MemmapDataset(args.dataset, args.ctx_len, args.max_examples)
    else:
        dataset = load_any_dataset(args.dataset, args.split)
        if "input_ids" not in dataset.column_names:
            if tokenizer is None:
                raise ValueError("a synthetic subject needs a tokenized dataset")
            dataset = chunk_and_tokenize(
                dataset, tokenizer, max_seq_len=args.ctx_len, num_proc=args.data_preprocessing_num_proc
            )
        else:
            print("Dataset already tokenized; skipping tokenization.")
        print(f"Shuffling dataset with seed {args.seed}")
        dataset = dataset.shuffle(args.seed)
        dataset = dataset.with_format("numpy")
        if limit := args.max_examples:
            dataset = dataset.select(range(limit))
    return model, dataset, tokenizer


def run(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> SaeTrainer:
    """Parse `argv` (the command line by default), train, and return the
    trainer."""
    args = parse_dataclass(RunConfig, argv)
    device = setup(device)
    model, dataset, _ = load_artifacts(args, device)
    print(f"Training on '{args.dataset}' (split '{args.split}')")
    trainer = SaeTrainer(args, dataset, model, device=device)
    if args.resume:
        trainer.load_state(args.run_name or "sae-ckpts")
    trainer.fit()
    return trainer


if __name__ == "__main__":
    run()
