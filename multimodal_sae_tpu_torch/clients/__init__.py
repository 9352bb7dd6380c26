from .client import Client, create_response_model
from .sglang import SRT
from .local import Local
from .openai import OpenAIClient
from .openrouter import OpenRouter
from .outlines import Outlines

__all__ = [
    "Client",
    "create_response_model",
    "SRT",
    "Local",
    "OpenAIClient",
    "OpenRouter",
    "Outlines",
]
