"""SAE training CLI:

    python -m multimodal_sae_tpu_torch <model> <dataset> [--hookpoints ...] ...

The flags of `python -m multimodal_sae_tpu` (reference
train/sae/sae/__main__.py:25-181, console script `sae`).  The subject is
`synthetic://dM,L,V` or a local LLaMA or LLaVA-NeXT checkpoint directory;
the dataset a `.bin` token file (uint16, as the reference writes it), a
local `Dataset.save_to_disk` directory or a hub name.  With `--mm_data` the
dataset holds LLaVA "conversations" and an `image` column (a LLaVA
checkpoint, whose tokenizer applies the chat template and pads the rows
through `DataCollatorForImage`).  One process trains on the CUDA card;
`run(device=...)` names another device (the tests pass "cpu").  Under
`torchrun --nproc_per_node N` each rank drives one card: the dataset is
cut to a length N divides and each rank trains on its contiguous shard,
data-parallel (`SaeTrainer`), or with `--distribute_modules` each rank
trains its block of the hookpoints on the whole global batch
(train/module_sharded.py).  `--load_in_8bit`, `--int8_matmul` and
`--int8_vision` quantise the subject (models/quant.py).  `--tp N` shards
the subject over each group of N consecutive ranks: the dataset is sharded
over the groups, every rank of a group trains the SAEs on the group's
hidden states, and the gradients are summed over the ranks that share
`rank % N`; with `--distribute_modules` as well, each rank of a group
trains its block of the hookpoints.  `--dp N` captures each batch's rows on N copies of the
subject in one process and gathers them on the trainer's card
(parallel/)."""

from __future__ import annotations

from typing import Optional, Sequence

from .config import RunConfig
from .device import DeviceLike, setup
from .launch.utils import load_any_dataset, load_subject_or_synthetic, shard_info
from .parallel import initialize_distributed
from .train import DataCollatorForImage, MemmapDataset, SaeTrainer, chunk_and_tokenize, process_mm_data
from .utils import rank0_print
from .utils.cli import parse_dataclass


def load_artifacts(args: RunConfig, device: DeviceLike = None):
    """The frozen subject and the training dataset (reference
    __main__.py:66-140): (model, dataset, tokenizer)."""
    model, _, tokenizer = load_subject_or_synthetic(args, device=device)

    if args.dataset.endswith(".bin"):
        dataset = MemmapDataset(args.dataset, args.ctx_len, args.max_examples)
    else:
        dataset = load_any_dataset(args.dataset, args.split)
        if "input_ids" not in dataset.column_names:
            if tokenizer is None:
                raise ValueError("a synthetic subject needs a tokenized dataset")
            if args.mm_data:
                dataset = process_mm_data(dataset, tokenizer)
            else:
                dataset = chunk_and_tokenize(
                    dataset, tokenizer, max_seq_len=args.ctx_len, num_proc=args.data_preprocessing_num_proc
                )
        else:
            rank0_print("Dataset already tokenized; skipping tokenization.")
        rank0_print(f"Shuffling dataset with seed {args.seed}")
        dataset = dataset.shuffle(args.seed)
        if args.mm_data:
            # Only the ids as numpy: numpy formatting would decode the image
            # column into arrays, which the LLaVA preprocessing cannot read
            # (the JAX CLI fails there).  The images stay PIL images.
            dataset = dataset.with_format("numpy", columns=["input_ids"], output_all_columns=True)
        else:
            dataset = dataset.with_format("numpy")
        if limit := args.max_examples:
            dataset = dataset.select(range(limit))
    return model, dataset, tokenizer


def run(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> SaeTrainer:
    """Parse `argv` (the command line by default), train, and return the
    trainer."""
    args = parse_dataclass(RunConfig, argv)
    device = setup(device)
    initialize_distributed(device)
    model, dataset, tokenizer = load_artifacts(args, device)
    rank, world = shard_info()
    if world > 1:
        # Cut to a length the ranks (the TP groups under --tp) divide, then
        # shard (reference __main__.py:164-166, JAX __main__.py:76-88).
        n = len(dataset) - len(dataset) % world
        dataset = dataset.select(range(n)).shard(world, rank)
    rank0_print(f"Training on '{args.dataset}' (split '{args.split}')")
    collator = None
    if args.mm_data:
        if tokenizer is None:
            raise ValueError("--mm_data needs the subject checkpoint's tokenizer for padding; a synthetic:// "
                             "subject has none")
        collator = DataCollatorForImage(tokenizer=tokenizer)
    trainer = SaeTrainer(args, dataset, model, device=device, collator=collator)
    if args.resume:
        trainer.load_state(args.run_name or "sae-ckpts")
    trainer.fit()
    return trainer


if __name__ == "__main__":
    run()
