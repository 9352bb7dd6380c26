"""Client for an already-running OpenAI-compatible server, e.g. vLLM
(behavior of reference sae_auto_interp/clients/local.py:10-61): chat
completions by default, the legacy /completions endpoint on request, with the
shared retry-and-backoff loop.

Copied from multimodal_sae_tpu/clients/local.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import json

from ..logger import logger
from .client import ChatTransport, Client, response_text, retry_chat


class Local(Client):
    provider = "vllm"

    def __init__(self, model: str, base_url: str = "http://localhost:8000/v1"):
        super().__init__(model)
        self.transport = ChatTransport(base_url, "EMPTY", timeout=None)
        self.model = model

    async def _legacy_completion(self, prompt: str, max_retries: int, raw: bool, **kwargs):
        last_err: Exception = RuntimeError("no attempts made")
        for attempt in range(max_retries):
            try:
                response = await self.transport.completions(
                    self.model, prompt, **kwargs
                )
                if response is None:
                    raise RuntimeError("Response is None")
                return response if raw else response["choices"][0]["text"]
            except (json.JSONDecodeError, Exception) as e:  # noqa: B014
                last_err = e
                logger.warning(f"Attempt {attempt + 1}: {e}, retrying...")
            await asyncio.sleep(1)
        logger.error(f"All retry attempts failed. Most recent error: {last_err}")
        raise last_err

    async def generate(
        self,
        prompt,
        raw: bool = False,
        use_legacy_api: bool = False,
        max_retries: int = 2,
        **kwargs,
    ) -> str:
        if use_legacy_api:
            return await self._legacy_completion(prompt, max_retries, raw, **kwargs)
        return await retry_chat(
            self.transport, self.model, prompt, max_retries=max_retries, raw=raw, **kwargs
        )

    def postprocess(self, response: dict) -> str:
        return response_text(response)
