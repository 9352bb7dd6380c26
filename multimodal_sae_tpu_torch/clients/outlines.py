"""Schema-constrained generation against a vLLM-style `/generate` endpoint
(reference sae_auto_interp/clients/outlines.py:11-78): applies the local chat
template, POSTs with a JSON schema constraint, parses the structured result.

Copied from multimodal_sae_tpu/clients/outlines.py; it uses no jax.
"""

from __future__ import annotations

import json
from typing import Optional

from ..logger import logger
from .client import Client


class Outlines(Client):
    provider = "outlines"

    def __init__(
        self,
        model: str,
        base_url: str = "http://localhost:8000/generate",
        tokenizer=None,
    ):
        super().__init__(model)
        self.url = base_url
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model)
        self.tokenizer = tokenizer
        self._client = None

    def _httpx(self):
        import httpx

        if self._client is None:
            self._client = httpx.AsyncClient(timeout=None)
        return self._client

    async def generate(self, prompt, schema: Optional[dict] = None, **kwargs):
        if not isinstance(prompt, str):
            prompt = self.tokenizer.apply_chat_template(
                prompt, tokenize=False, add_generation_prompt=True
            )
        data = {"text": prompt, **kwargs}
        if schema is not None:
            data["json_schema"] = schema
        try:
            response = await self._httpx().post(self.url, json=data)
            response.raise_for_status()
            text = response.json()["text"]
            if isinstance(text, list):
                text = text[0]
            generated = text[len(prompt):] if text.startswith(prompt) else text
            if schema is not None:
                return json.loads(generated)
            return generated
        except Exception as e:
            logger.error(f"Outlines generate failed: {e}")
            raise
