from .cli import add_dataclass_args, dataclass_from_namespace, parse_dataclass
from .misc import natsort_key, natsorted, process_count, process_index, rank0_print, rank_print
from .profiling import maybe_trace, timed

__all__ = [
    "natsorted",
    "natsort_key",
    "process_count",
    "process_index",
    "rank0_print",
    "rank_print",
    "parse_dataclass",
    "add_dataclass_args",
    "dataclass_from_namespace",
    "maybe_trace",
    "timed",
]
