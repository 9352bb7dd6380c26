from .api import ActivationSource, SyntheticActivationSource
from .llama import LlamaConfig, LlamaModel, llama_forward, pad_text_rows
from .llava_next import LlavaNextConfig, LlavaNextModel

__all__ = [
    "ActivationSource",
    "SyntheticActivationSource",
    "LlamaConfig",
    "LlamaModel",
    "LlavaNextConfig",
    "LlavaNextModel",
    "llama_forward",
    "pad_text_rows",
]
