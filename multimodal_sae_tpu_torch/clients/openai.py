"""OpenAI / Azure chat client (reference sae_auto_interp/clients/openai.py:14-95).

Copied from multimodal_sae_tpu/clients/openai.py; it uses no jax.
"""

from __future__ import annotations

import os
from typing import Optional

from .client import ChatTransport, Client, encode_image_base64, retry_chat


class OpenAIClient(Client):
    provider = "openai"

    def __init__(
        self,
        model: str,
        api_key: Optional[str] = None,
        base_url: Optional[str] = None,
        azure_endpoint: Optional[str] = None,
        api_version: str = "2024-02-01",
    ):
        super().__init__(model)
        self.azure = azure_endpoint is not None
        if self.azure:
            key = api_key or os.environ.get("AZURE_OPENAI_API_KEY", "")
            # Azure routes by deployment and requires api-version in the URL.
            url = f"{azure_endpoint.rstrip('/')}/openai/deployments/{model}"
            self.transport = ChatTransport(
                url,
                key,
                extra_headers={"api-key": key},
                url_suffix=f"?api-version={api_version}",
            )
        else:
            key = api_key or os.environ.get("OPENAI_API_KEY", "")
            self.transport = ChatTransport(base_url or "https://api.openai.com/v1", key)

    async def generate(self, prompt, raw: bool = False, max_retries: int = 2, **kwargs):
        if isinstance(prompt, str):
            messages = [{"role": "user", "content": prompt}]
        else:
            messages = prompt
        return await retry_chat(
            self.transport, self.model, messages, max_retries=max_retries, raw=raw, **kwargs
        )

    def encode_images(self, image):
        return encode_image_base64(image)
