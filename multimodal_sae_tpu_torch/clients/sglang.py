"""SRT client: explainer-model serving endpoint, optionally spawning a local
sglang server (reference sae_auto_interp/clients/sglang.py:16-185).

The reference always spawns an sglang subprocess with tensor-parallel serving
(`--tensor-parallel-size tp`, sglang.py:33-37).  Here server spawning is kept
but optional: if `launch_server=True` and the `sglang` package is importable
the same subprocess is launched; otherwise SRT attaches to an already-running
OpenAI-compatible endpoint at `base_url` (a serving stack of its own or any external
server).  Request/response behavior (retry loop, image encoding, message
shapes) is identical.

Copied from multimodal_sae_tpu/clients/sglang.py; it uses no jax.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, List, Optional, Union

from ..logger import logger
from .client import ChatTransport, Client, encode_image_base64, retry_chat


class SRT(Client):
    provider = "sglang"

    def __init__(
        self,
        model: str,
        base_url: str = "http://localhost:8000",
        tp: int = 8,
        timeout: int = 600,
        launch_server: Optional[bool] = None,
        mem_fraction_static: float = 0.75,
    ):
        super().__init__(model)
        self.base_url = base_url
        self.model = model
        self.process = None

        if launch_server is None:
            launch_server = _sglang_available()
        if launch_server:
            self.process = self._launch(model, base_url, tp, mem_fraction_static)

        self.transport = ChatTransport(self.base_url.rstrip("/") + "/v1", "EMPTY", timeout)
        self.timeout = timeout

    def _launch(self, model, base_url, tp, mem_fraction_static):
        """Spawn `python -m sglang.launch_server` and wait for readiness
        (reference popen_launch_server, sglang.py:38-44)."""
        host, port = _split_host_port(base_url)
        args = [
            sys.executable,
            "-m",
            "sglang.launch_server",
            "--model-path",
            model,
            "--host",
            host,
            "--port",
            str(port),
            "--tensor-parallel-size",
            str(tp),
            "--mem-fraction-static",
            str(mem_fraction_static),
        ]
        if "llava" in model:
            args.extend(["--chat-template", "chatml-llava"])
        logger.info(f"Launching sglang server: {' '.join(args)}")
        # New session: sglang forks tp-worker/scheduler subprocesses, and
        # clean()'s SIGKILL fallback cannot be forwarded to them through the
        # parent — killpg over the session is the only way the "kill the
        # spawned server tree" contract holds (orphaned tp=8 workers would
        # keep the accelerators and the port after a crash).
        proc = subprocess.Popen(args, start_new_session=True)
        _wait_health(base_url, proc)
        return proc

    async def generate(
        self,
        prompt: Union[str, List[Dict]],
        raw: bool = False,
        temperature: float = 0,
        max_retries: int = 2,
        **kwargs,
    ) -> str:
        if isinstance(prompt, str):
            messages = [{"role": "user", "content": [{"type": "text", "text": prompt}]}]
        else:
            messages = prompt
        return await retry_chat(
            self.transport,
            self.model,
            messages,
            max_retries=max_retries,
            raw=raw,
            temperature=temperature,
            timeout=self.timeout,
            **kwargs,
        )

    async def single_image_generate(
        self,
        prompt: str,
        image_path: str,
        raw: bool = False,
        max_retries: int = 2,
        temperature: float = 0,
        max_new_tokens: int = 4096,
        **kwargs,
    ) -> str:
        """One image + text prompt (reference sglang.py:95-146)."""
        from PIL import Image

        encode_img = self.encode_images(Image.open(image_path))
        messages = [
            {
                "role": "user",
                "content": [
                    {
                        "type": "image_url",
                        "image_url": {"url": f"data:image/png;base64,{encode_img}"},
                    },
                    {"type": "text", "text": prompt},
                ],
            }
        ]
        return await retry_chat(
            self.transport,
            self.model,
            messages,
            max_retries=max_retries,
            raw=raw,
            temperature=temperature,
            max_tokens=max_new_tokens,
            timeout=self.timeout,
            **kwargs,
        )

    def encode_images(self, image):
        return encode_image_base64(image)

    def non_async_generate(self, prompt: str, **kwargs) -> str:
        """Synchronous smoke-test request (reference sglang.py:158-176)."""
        import asyncio

        return asyncio.run(self.generate(prompt, **kwargs))

    def postprocess(self, response: dict) -> str:
        return response["choices"][0]["message"]["content"]

    def clean(self):
        """Kill the spawned server tree (reference sglang.py:184-185): the
        whole process GROUP (see _launch's start_new_session), so sglang's
        tp workers die with the parent even on the SIGKILL path."""
        if self.process is not None:
            import os
            import signal

            def _signal_group(sig, fallback):
                try:
                    os.killpg(os.getpgid(self.process.pid), sig)
                except (ProcessLookupError, PermissionError, OSError):
                    fallback()  # already dead, or not a group leader

            _signal_group(signal.SIGTERM, self.process.terminate)
            try:
                self.process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                _signal_group(signal.SIGKILL, self.process.kill)
                try:
                    self.process.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass


def _sglang_available() -> bool:
    try:
        import sglang  # noqa: F401

        return True
    except ImportError:
        return False


def _split_host_port(base_url: str):
    rest = base_url.split("//", 1)[-1]
    host, _, port = rest.partition(":")
    return host or "127.0.0.1", int(port or 8000)


def _wait_health(base_url: str, proc, timeout: float = 18000):
    import httpx

    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError("sglang server exited during startup")
        try:
            r = httpx.get(f"{base_url}/health", timeout=5)
            if r.status_code == 200:
                return
        except Exception:
            pass
        time.sleep(2)
    raise TimeoutError("sglang server did not become healthy in time")
