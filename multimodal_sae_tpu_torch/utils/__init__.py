from .cli import add_dataclass_args, dataclass_from_namespace, parse_dataclass
from .misc import natsort_key, natsorted

__all__ = [
    "natsorted",
    "natsort_key",
    "parse_dataclass",
    "add_dataclass_args",
    "dataclass_from_namespace",
]
