"""OpenRouter chat client (reference sae_auto_interp/clients/openrouter.py:14-68),
built on the shared OpenAI-compatible ChatTransport/retry loop from client.py
rather than its own copy of the httpx + retry machinery.

Copied from multimodal_sae_tpu/clients/openrouter.py; it uses no jax.
"""

from __future__ import annotations

import os
from typing import Optional

from .client import ChatTransport, Client, retry_chat


class OpenRouter(Client):
    provider = "openrouter"

    def __init__(
        self,
        model: str,
        api_key: Optional[str] = None,
        base_url: str = "https://openrouter.ai/api/v1/chat/completions",
    ):
        super().__init__(model)
        # The reference takes the full /chat/completions URL; ChatTransport
        # wants the API root and appends the suffix itself.
        root = base_url.rstrip("/")
        suffix = "/chat/completions"
        if root.endswith(suffix):
            root = root[: -len(suffix)]
        self.url = base_url
        self.api_key = api_key or os.environ.get("OPENROUTER_API_KEY", "")
        self.transport = ChatTransport(root, self.api_key)

    async def generate(
        self, prompt, raw: bool = False, max_retries: int = 2, **kwargs
    ) -> str:
        if isinstance(prompt, str):
            prompt = [{"role": "user", "content": prompt}]
        return await retry_chat(
            self.transport,
            self.model,
            prompt,
            max_retries=max_retries,
            raw=raw,
            **kwargs,
        )
