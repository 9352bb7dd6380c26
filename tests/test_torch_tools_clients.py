"""The port's client tools (`multimodal_sae_tpu_torch/tools/label_explanation.py`
and `gpt4o_consistency.py`) against the JAX package's `tools/*.py`, each
side run in-process against the same stub server: an `httpx.MockTransport`
that every `httpx.AsyncClient` of the run is built on (no socket), which
records each request and answers in the OpenAI chat format.  Requests are
answered as they arrive, in one event loop, so the order of the replies,
and with it each output file, is the same on both sides: the request
bodies and the written json compare byte for byte."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

httpx = pytest.importorskip("httpx")

from multimodal_sae_tpu_torch.tools import gpt4o_consistency as port_gpt4o  # noqa: E402
from multimodal_sae_tpu_torch.tools import label_explanation as port_label  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class StubServer:
    """Records (url, body) of each request; answers a reply that depends on
    the body, or HTTP 400 when the body holds `refuse`."""

    def __init__(self, refuse=None):
        self.requests, self.refuse = [], refuse

    def handler(self, request: httpx.Request) -> httpx.Response:
        body = request.content.decode()
        self.requests.append((str(request.url), body))
        if self.refuse is not None and self.refuse in body:
            return httpx.Response(400, text="refused")
        reply = ("scene", "object", "texture", "0", "1")[len(body) % 5]
        return httpx.Response(200, json={"choices": [{"message": {"role": "assistant", "content": reply}}]})


@pytest.fixture
def stub(monkeypatch):
    """A `StubServer` factory; every AsyncClient made afterwards talks to
    the latest one."""
    real = httpx.AsyncClient
    current = {}

    def client(**kw):
        return real(transport=httpx.MockTransport(current["server"].handler), **kw)

    monkeypatch.setattr(httpx, "AsyncClient", client)

    def make(**kw):
        current["server"] = StubServer(**kw)
        return current["server"]

    return make


def test_label_explanation_matches_jax(tmp_path, stub, monkeypatch):
    """Nine explanations, one the sentinel: eight requests of the same
    bodies, the sentinel skipped, the labels json equal byte for byte."""
    explanations = {f"layers.24_feature{i}": f"description {i} " + "x" * i for i in range(9)}
    explanations["layers.24_feature4"] = "Unable to produce descriptions for this feature"
    (tmp_path / "refined.json").write_text(json.dumps(explanations))
    servers = {}
    for side in ("jax", "port"):
        servers[side] = stub()
        argv = ["--refined-explanation", str(tmp_path / "refined.json"), "--save-path", str(tmp_path / f"{side}.json"),
                "--base-url", "http://stub:8000"]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["label_explanation", *argv])
            _jax_tool("label_explanation").main()
        else:
            port_label.main(argv)
    assert servers["port"].requests == servers["jax"].requests
    assert len(servers["port"].requests) == 8
    assert all(url == "http://stub:8000/v1/chat/completions" for url, _ in servers["port"].requests)
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    labels = json.loads(want)
    assert "layers.24_feature4" not in labels and len(labels) == 8
    assert all(json.loads(body)["max_tokens"] == 16 for _, body in servers["port"].requests)


def _explanation_dir(root: Path, features, with_images) -> Path:
    from PIL import Image

    exp = root / "explanations"
    exp.mkdir()
    (exp / "model.layers.24.json").write_text(json.dumps(
        [{f: f"explanation of {f}", "prompt": "p"} for f in features]))
    rng = np.random.default_rng(0)
    for n, f in enumerate(with_images):
        folder = exp / "images" / "model_layers_24" / f / "activated_images"
        folder.mkdir(parents=True)
        for j in range(1 + n % 3):
            Image.fromarray(rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)).save(folder / f"{j}.png")
    return exp


def test_gpt4o_consistency_matches_jax_and_resumes(tmp_path, stub, monkeypatch):
    """A label file of two labels (105 features under one, so its first 100
    are sampled), a resume cache holding one judged feature, one failed
    (-1) and one unsampled: the judged feature is not asked again, the
    failed one is, a refused request scores -1; the request bodies (the
    images base64-encoded) and the result json equal byte for byte."""
    labels = {f"model.layers.24_feature{i}": ("object" if i % 2 else "scene") for i in range(4)}
    labels.update({f"model.layers.24_feature{i}": "texture" for i in range(10, 115)})
    features = list(labels)
    exp = _explanation_dir(tmp_path, features, features[:3])
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    cache = {features[0]: "1", features[1]: -1, "model.layers.24_feature999": "0"}
    monkeypatch.setenv("OPENAI_API_ENDPOINT", "http://stub")
    monkeypatch.setenv("OPENAI_API_KEY", "key")
    servers = {}
    for side in ("jax", "port"):
        save = tmp_path / side / "scores.json"
        save.parent.mkdir()
        save.write_text(json.dumps(cache, indent=4))
        servers[side] = stub(refuse=f"explanation of {features[2]}\\n")
        argv = ["--explanation-dir", str(exp), "--label-file", str(tmp_path / "labels.json"),
                "--save-path", str(save)]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["gpt4o_consistency", *argv])
            _jax_tool("gpt4o_consistency").main()
        else:
            port_gpt4o.main(argv)
    assert servers["port"].requests == servers["jax"].requests
    requests = servers["port"].requests
    # 4 + 100 sampled, less the one judged before.
    assert len(requests) == 103
    assert all(url.startswith("http://stub/openai/deployments/gpt-4o/chat/completions?api-version=")
               for url, _ in requests)
    # features[1] has two images, then its explanation.
    (retried,) = [json.loads(body) for _, body in requests if f"explanation of {features[1]}\\n" in body]
    content = retried["messages"][0]["content"]
    assert [c["type"] for c in content] == ["image_url", "image_url", "text"]
    want = (tmp_path / "jax" / "scores.json").read_bytes()
    assert (tmp_path / "port" / "scores.json").read_bytes() == want
    scores = json.loads(want)
    assert scores[features[0]] == "1" and scores["model.layers.24_feature999"] == "0"
    assert scores[features[1]] != -1 and scores[features[2]] == -1
    assert "model.layers.24_feature110" not in scores and len(scores) == 104 + 1
    assert not (tmp_path / "port" / "scores.json.tmp").exists()


def test_judge_all_writes_each_reply_through_a_whole_file(tmp_path):
    """The core on a stub client: after every reply the result file holds
    every score so far (the rewrite goes through a temporary file)."""
    import asyncio

    seen = []

    class Client:
        async def generate(self, messages):
            if messages == "b":
                raise RuntimeError("transient")
            seen.append(json.loads((tmp_path / "s.json").read_text()) if (tmp_path / "s.json").exists() else None)
            return "1"

    scores = {"c": "0"}
    out = asyncio.run(port_gpt4o.judge_all(Client(), ["a", "b", "c"], scores, lambda f: f, str(tmp_path / "s.json")))
    assert out == {"c": "0", "a": "1", "b": -1}
    assert seen == [None]
    assert json.loads((tmp_path / "s.json").read_text()) == out
