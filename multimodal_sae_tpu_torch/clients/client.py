"""LLM client base (reference sae_auto_interp/clients/client.py:6-20) plus the
shared OpenAI-compatible async chat transport.

The reference builds every client on the `openai` SDK; that package is not a
hard dependency here, so the transport is a small httpx wrapper speaking the
same `/chat/completions` protocol (any OpenAI-compatible server: sglang,
vLLM, OpenAI, Azure, routers).

Copied from multimodal_sae_tpu/clients/client.py; it uses no jax.
"""

from __future__ import annotations

import asyncio
import base64
import json
from abc import ABC, abstractmethod
from io import BytesIO
from typing import Dict, List, Optional, Union

from ..logger import logger


class Client(ABC):
    def __init__(self, model: str):
        self.model = model

    @abstractmethod
    async def generate(self, prompt: str, **kwargs):
        raise NotImplementedError


def create_response_model(n: int, type: type = int):
    """Dynamic pydantic model with `example_{i}` fields
    (reference client.py:15-20)."""
    from pydantic import create_model

    fields = {f"example_{i}": (type, ...) for i in range(n)}
    return create_model("ResponseModel", **fields)


def encode_image_base64(image) -> str:
    """PIL image -> base64 PNG string (reference sglang.py:148-156)."""
    output_buffer = BytesIO()
    image.save(output_buffer, format="PNG")
    return base64.b64encode(output_buffer.getvalue()).decode("utf-8")


class ChatTransport:
    """Async OpenAI-compatible chat-completions transport over httpx."""

    def __init__(
        self,
        base_url: str,
        api_key: str = "EMPTY",
        timeout: Optional[float] = 600,
        extra_headers: Optional[Dict[str, str]] = None,
        url_suffix: str = "",
    ):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.extra_headers = extra_headers or {}
        self.url_suffix = url_suffix  # e.g. Azure's "?api-version=..."
        self._client = None

    def _httpx(self):
        import httpx

        if self._client is None:
            self._client = httpx.AsyncClient(timeout=self.timeout)
        return self._client

    async def chat(self, model: str, messages: List[Dict], **kwargs) -> dict:
        headers = {
            "Authorization": f"Bearer {self.api_key}",
            "Content-Type": "application/json",
            **self.extra_headers,
        }
        # `timeout` is an HTTP request option, never part of the chat body —
        # strict OpenAI-compatible servers 400 on unknown fields.
        timeout = kwargs.pop("timeout", None)
        request_opts = {} if timeout is None else {"timeout": timeout}
        payload = {"model": model, "messages": messages, **kwargs}
        resp = await self._httpx().post(
            f"{self.base_url}/chat/completions{self.url_suffix}",
            headers=headers,
            json=payload,
            **request_opts,
        )
        resp.raise_for_status()
        return resp.json()

    async def completions(self, model: str, prompt: str, **kwargs) -> dict:
        headers = {"Authorization": f"Bearer {self.api_key}"}
        payload = {"model": model, "prompt": prompt, **kwargs}
        resp = await self._httpx().post(
            f"{self.base_url}/completions", headers=headers, json=payload
        )
        resp.raise_for_status()
        return resp.json()

    async def aclose(self):
        if self._client is not None:
            await self._client.aclose()


def response_text(response: dict) -> str:
    """Extract assistant text (reference postprocess, sglang.py:178-182)."""
    return response["choices"][0]["message"]["content"]


async def retry_chat(
    transport: ChatTransport,
    model: str,
    messages,
    max_retries: int = 2,
    raw: bool = False,
    **kwargs,
) -> Union[str, dict]:
    """Retry-with-backoff request loop (reference sglang.py:68-93).

    Deterministic client errors (HTTP 4xx other than 408/429) abort
    immediately: a wrong model name or oversized prompt fails identically
    on every attempt, and a pipeline of thousands of records would
    otherwise multiply max_retries requests + sleeps into every one.
    408/429 and all 5xx/transport errors stay retryable."""
    last_err = None
    for attempt in range(max_retries):
        try:
            response = await transport.chat(model, messages, **kwargs)
            if response is None:
                raise RuntimeError("Response is None")
            return response if raw else response_text(response)
        except json.JSONDecodeError as e:
            last_err = e
            logger.warning(f"Attempt {attempt + 1}: Invalid JSON response, retrying... {e}")
        except Exception as e:
            status = getattr(getattr(e, "response", None), "status_code", None)
            if status is not None and 400 <= status < 500 and status not in (408, 429):
                logger.error(f"Non-retryable HTTP {status}: {e}")
                raise
            last_err = e
            logger.warning(f"Attempt {attempt + 1}: {e}, retrying...")
        if attempt + 1 < max_retries:  # no pointless sleep after the last try
            await asyncio.sleep(1)
    logger.error(f"All retry attempts failed. Most recent error: {last_err}")
    raise last_err
