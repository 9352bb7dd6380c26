"""Multi-process runs on `torch.distributed` (multimodal_sae_tpu/parallel):
bring-up, the launch layer's host collectives, the row exchange of
module-sharded training (`all_to_all_rows`) and the host sharding helpers.
One process drives one card; tensor parallelism and the in-process `--dp`
replicas are not ported yet (ROADMAP.md §1)."""

from .collectives import all_gather_objects, all_to_all_rows, barrier, gather_objects
from ..utils.misc import process_count, process_index
from .distributed import initialize_distributed
from .mesh import local_shard_bounds, shard_dataset_contiguous

__all__ = [
    "all_gather_objects",
    "all_to_all_rows",
    "barrier",
    "gather_objects",
    "initialize_distributed",
    "local_shard_bounds",
    "process_count",
    "process_index",
    "shard_dataset_contiguous",
]
