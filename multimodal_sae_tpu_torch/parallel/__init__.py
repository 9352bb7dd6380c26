"""Multi-process runs on `torch.distributed` (multimodal_sae_tpu/parallel):
bring-up, the launch layer's host collectives, the row exchange of
module-sharded training (`all_to_all_rows`), the host sharding helpers,
tensor parallelism on process groups (`--tp`, tensor_parallel.py) and the
in-process `--dp` replicas (data_parallel.py).  One process drives one
card, or under `--dp` several."""

from .collectives import all_gather_objects, all_to_all_rows, barrier, gather_objects
from ..utils.misc import process_count, process_index
from .data_parallel import place_rows, place_rows_padded, shard_subject_model_dp
from .distributed import initialize_distributed
from .mesh import local_shard_bounds, shard_dataset_contiguous
from .tensor_parallel import llama_param_specs, replicate_saes, shard_llama_params, shard_subject_model

__all__ = [
    "all_gather_objects",
    "all_to_all_rows",
    "barrier",
    "gather_objects",
    "initialize_distributed",
    "llama_param_specs",
    "local_shard_bounds",
    "place_rows",
    "place_rows_padded",
    "process_count",
    "process_index",
    "replicate_saes",
    "shard_dataset_contiguous",
    "shard_llama_params",
    "shard_subject_model",
    "shard_subject_model_dp",
]
