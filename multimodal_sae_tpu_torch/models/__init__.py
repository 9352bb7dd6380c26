from .api import ActivationSource, SyntheticActivationSource
from .llama import LlamaConfig, LlamaModel, llama_forward

__all__ = [
    "ActivationSource",
    "SyntheticActivationSource",
    "LlamaConfig",
    "LlamaModel",
    "llama_forward",
]
