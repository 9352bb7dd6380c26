"""The port's interpretation layer (clients, explainers, scorers, label
refiner, pipeline, explain writer) against the JAX package's copies of the
same modules.

Both packages get the same records (numpy-seeded), the same stub clients
and the same fake HTTP transports (`httpx.MockTransport`: no server, no
socket).  Prompts, request bodies, parsed results and written files must be
equal, byte for byte where they are bytes; there is no float arithmetic
beyond the shared numpy, so no tolerance."""

import asyncio
import json
import random

import numpy as np
import pytest

import httpx

import multimodal_sae_tpu.agents as jax_agents
import multimodal_sae_tpu.clients as jax_clients
import multimodal_sae_tpu.clients.client as jax_client_mod
import multimodal_sae_tpu.features.features as jax_features
import multimodal_sae_tpu.launch.explain._writer as jax_writer
import multimodal_sae_tpu.pipeline as jax_pipeline
import multimodal_sae_tpu.prompt as jax_prompt
import multimodal_sae_tpu_torch.agents as agents
import multimodal_sae_tpu_torch.clients as clients
import multimodal_sae_tpu_torch.clients.client as client_mod
import multimodal_sae_tpu_torch.features.features as features
import multimodal_sae_tpu_torch.launch.explain._writer as writer
import multimodal_sae_tpu_torch.pipeline as pipeline
import multimodal_sae_tpu_torch.prompt as prompt

PACKAGES = {
    "jax": dict(agents=jax_agents, clients=jax_clients, client=jax_client_mod, features=jax_features,
                writer=jax_writer, pipeline=jax_pipeline),
    "port": dict(agents=agents, clients=clients, client=client_mod, features=features, writer=writer,
                 pipeline=pipeline),
}


class StubClient:
    """Canned-reply async client that records every prompt."""

    def __init__(self, response):
        self.response = response
        self.calls = []

    async def generate(self, prompt, **kwargs):
        self.calls.append((prompt, kwargs))
        return self.response


class StubTokenizer:
    def batch_decode(self, token_lists, **kw):
        return ["tok%d" % t[0] for t in token_lists]


def _record(pkg, n_examples=12, seq=8, seed=0):
    f = PACKAGES[pkg]["features"]
    rng = np.random.default_rng(seed)
    rec = f.FeatureRecord(f.Feature("model.layers.24", 123))
    examples = []
    for i in range(n_examples):
        acts = np.zeros(seq, dtype=np.float32)
        acts[i % seq] = 5.0 - 0.1 * i
        acts[(i + 3) % seq] = rng.uniform(0, 4)
        examples.append(f.Example(tokens=rng.integers(0, 50, size=seq), activations=acts))
    rec.examples = examples
    rec.train = examples[:n_examples]
    rec.explanation = "tokens about cats"
    rec.top_logits = ["cat", "dog", "mouse"]
    return rec


def _on_both(fn):
    out = {pkg: fn(pkg) for pkg in PACKAGES}
    return out["jax"], out["port"]


def _plain(result):
    """A result with its record replaced by the feature's name."""
    if isinstance(result, tuple) and hasattr(result, "_fields"):
        return {k: (str(v.feature) if k == "record" else v) for k, v in result._asdict().items()}
    if isinstance(result, tuple):
        return [_plain(r) for r in result]
    return result


def test_the_prompt_library_is_the_same():
    for name in ("STEERING_FILTER_PROMPT", "CONCEPT_LABEL_PROMPT", "GPT_CONSISTENCY_PROMPT"):
        assert getattr(prompt, name) == getattr(jax_prompt, name)


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("options", [{}, {"activations": True}, {"cot": True, "logits": True, "activations": True}],
                         ids=["plain", "activations", "cot-logits"])
def test_simple_explainer(options, verbose):
    def run(pkg):
        client = StubClient("blah\n[EXPLANATION]: tokens about cats")
        explainer = PACKAGES[pkg]["agents"].SimpleExplainer(client, StubTokenizer(), verbose=verbose,
                                                            temperature=0.3, **options)
        return client.calls, _plain(asyncio.run(explainer(_record(pkg))))

    (jax_calls, jax_out), (calls, out) = _on_both(run)
    assert json.dumps(calls) == json.dumps(jax_calls)
    assert out == jax_out
    assert "tokens about cats" in json.dumps(out)


def test_simple_explainer_unparseable():
    def run(pkg):
        explainer = PACKAGES[pkg]["agents"].SimpleExplainer(StubClient("no marker"), StubTokenizer())
        return asyncio.run(explainer(_record(pkg))).explanation

    assert _on_both(run) == ("Explanation could not be parsed.",) * 2


def test_image_explainer():
    from PIL import Image

    def run(pkg):
        client = StubClient("[EXPLANATION]: mesh-like structures")
        rec = _record(pkg, n_examples=5)
        for i, ex in enumerate(rec.train):
            ex.activation_image = Image.new("RGB", (8, 8), (40 * i, 0, 255 - 40 * i))
        result = asyncio.run(PACKAGES[pkg]["agents"].ImageExplainer(client, verbose=True)(rec))
        return client.calls, _plain(result)

    (jax_calls, jax_out), (calls, out) = _on_both(run)
    assert json.dumps(calls) == json.dumps(jax_calls)
    assert out == jax_out
    assert sum(part.get("type") == "image_url" for part in calls[0][0][-1]["content"]) == 5


@pytest.mark.parametrize("reply", ["the scores are [3, 0, 1, 2, 3]", "I refuse"], ids=["parsed", "malformed"])
def test_simple_scorer(reply):
    def run(pkg):
        client = StubClient(reply)
        scorer = PACKAGES[pkg]["agents"].SimpleScorer(client, StubTokenizer(), verbose=True, threshold=0.5,
                                                      activations=True)
        return client.calls, _plain(asyncio.run(scorer(_record(pkg))))

    (jax_calls, jax_out), (calls, out) = _on_both(run)
    assert len(calls) == 3  # 12 examples in groups of 5
    assert json.dumps(calls) == json.dumps(jax_calls)
    assert out == jax_out


def test_label_refiner(tmp_path):
    def run(pkg):
        client = StubClient("[ANSWER] Honda vehicles")
        refiner = PACKAGES[pkg]["agents"].LabelRefiner(
            client, {"f1": "long description of honda", "f2": "Unable to produce descriptions"})
        asyncio.run(refiner.refine())
        refiner.save_result(str(tmp_path / f"{pkg}.json"))
        return client.calls, refiner.refine_features, (tmp_path / f"{pkg}.json").read_bytes()

    jax_out, out = _on_both(run)
    assert json.dumps(out[0]) == json.dumps(jax_out[0])
    assert out[1:] == jax_out[1:]


def test_explanation_loaders(tmp_path):
    (tmp_path / "model.layers.24_feature123.txt").write_text(json.dumps("OWN"))
    (tmp_path / "model.layers.24_feature999.txt").write_text(json.dumps("OTHER"))

    def run(pkg):
        a = PACKAGES[pkg]["agents"]
        rec = _record(pkg)
        random.seed(0)
        own = asyncio.run(a.explanation_loader(rec, str(tmp_path))).explanation
        others = [asyncio.run(a.random_explanation_loader(rec, str(tmp_path))).explanation for _ in range(5)]
        return own, others

    assert _on_both(run) == (("OWN", ["OTHER"] * 5),) * 2


def test_pipeline_runs_isolates_failures_and_collates():
    def run(pkg):
        p = PACKAGES[pkg]["pipeline"]
        done, seen = [], []

        async def flaky(record):
            if record == 2:
                raise RuntimeError("boom")
            done.append(record)
            return record

        asyncio.run(p.Pipeline(lambda collate: [[0, 1, 2, 3, 4]], flaky).run(max_processes=2))

        async def double(x):
            return 2 * x

        pipe = p.Pipe(p.process_wrapper(double, preprocess=lambda r: r + 1, postprocess=seen.append), double)
        asyncio.run(p.Pipeline(lambda collate: [5, 6] if collate else iter([[5, 6]]), pipe).run(collate=True))

        async def always_fails(record):
            raise RuntimeError("endpoint down")

        with pytest.raises(RuntimeError, match="endpoint down"):
            asyncio.run(p.Pipeline(lambda collate: [[0, 1]], always_fails).run(max_processes=2))
        return sorted(done), sorted(seen)

    assert _on_both(run) == (([0, 1, 3, 4], [12, 14]),) * 2


def test_explain_writer_files_are_byte_equal(tmp_path):
    def run(pkg):
        (tmp_path / pkg).mkdir()
        w = PACKAGES[pkg]["writer"].ModuleRowWriter(str(tmp_path / pkg), flush_every=3)
        for i in range(5):
            w.append("m.json", {f"m_feature{i}": f"expl {i} ü", "prompt": "p\n\"q\""})
        w.append("other.json", {"g": "h"})
        w.close()
        return {f.name: f.read_bytes() for f in sorted((tmp_path / pkg).iterdir())}

    jax_files, files = _on_both(run)
    assert files == jax_files and len(files) == 2


def test_clip_scorer_with_an_injected_metric(tmp_path):
    from PIL import Image

    (tmp_path / "model_layers_24.json").write_text(json.dumps([
        {"model.layers.24_feature1": "a red square", "prompt": "..."},
        {"model.layers.24_feature2": "Unable to produce descriptions", "prompt": "..."},
    ]))
    img_dir = tmp_path / "images" / "model_layers_24" / "model.layers.24_feature1" / "images"
    img_dir.mkdir(parents=True)
    for i, color in enumerate([(255, 0, 0), (0, 0, 255), (250, 9, 9)]):
        Image.new("RGB", (16, 16), color).save(img_dir / f"top{i}.png")

    class Images:
        def __init__(self):
            self.rows = [Image.new("RGB", (4, 4), (25 * i, 0, 0)) for i in range(9)]

        def __len__(self):
            return len(self.rows)

        def select(self, idx):
            return {"image": [self.rows[i] for i in idx]}

        def __iter__(self):
            return iter([{"feature": "model.layers.24_feature1", "image": self.rows[3]}])

    def metric(image, text):
        return float(np.asarray(image)[0, 0, 0]) / 3 + len(text)

    def run(pkg):
        a = PACKAGES[pkg]["agents"]
        out = []
        for eval_type in ("default", "random"):
            scorer = a.ClipScorer(str(tmp_path), dataset_path=None, metric=metric, dataset=Images(), k=2,
                                  evaluation_type=eval_type, random_runs=3, seed=5)
            out.append(json.dumps(scorer.run(), indent=4))
        out.append(json.dumps(a.GeneratedClipScorer(str(tmp_path), dataset_path=None, metric=metric,
                                                    dataset=Images()).run(), indent=4))
        return out

    jax_out, out = _on_both(run)
    assert out == jax_out
    default = {s["feature"]: s for s in json.loads(out[0])}
    assert default["model.layers.24_feature1"]["k"] == 3 and default["model.layers.24_feature2"]["avg_score"] == -1


# ---- clients through a fake transport -------------------------------------------------


class FakeServer:
    """An `httpx.MockTransport` that records each request and answers in
    the OpenAI chat format (or the `/generate` format), failing the first
    `fail` requests with `status`."""

    def __init__(self, reply="stub reply", fail=0, status=500):
        self.requests, self.reply, self.fail, self.status = [], reply, fail, status

    def handler(self, request: httpx.Request) -> httpx.Response:
        self.requests.append({"method": request.method, "url": str(request.url),
                              "auth": request.headers.get("authorization"),
                              "api-key": request.headers.get("api-key"), "body": request.content})
        if len(self.requests) <= self.fail:
            return httpx.Response(self.status, text="boom")
        if request.url.path.endswith("/generate"):
            return httpx.Response(200, json={"text": [json.loads(request.content)["text"] + self.reply]})
        if request.url.path.endswith("/completions") and not request.url.path.endswith("chat/completions"):
            return httpx.Response(200, json={"choices": [{"text": self.reply}]})
        return httpx.Response(200, json={"choices": [{"message": {"role": "assistant", "content": self.reply}}]})

    def client(self):
        return httpx.AsyncClient(transport=httpx.MockTransport(self.handler))


def _drive(pkg, make, call, server):
    c = make(PACKAGES[pkg]["clients"])
    holder = getattr(c, "transport", c)
    holder._client = server.client()
    return asyncio.run(call(c))


CLIENT_CASES = {
    "srt": (lambda m: m.SRT(model="test-model", base_url="http://fake:8000", launch_server=False),
            lambda c: c.generate("hello", temperature=0.5, max_new_tokens=7)),
    "srt-messages": (lambda m: m.SRT(model="test-model", base_url="http://fake:8000", launch_server=False),
                     lambda c: c.generate([{"role": "user", "content": "hi"}], raw=True)),
    "openai": (lambda m: m.OpenAIClient("gpt-x", api_key="sk-test", base_url="http://fake"),
               lambda c: c.generate("hi", max_tokens=3)),
    "azure": (lambda m: m.OpenAIClient("my-deploy", api_key="az-key", azure_endpoint="http://fake"),
              lambda c: c.generate([{"role": "user", "content": "hi"}])),
    "openrouter": (lambda m: m.OpenRouter("some/model", api_key="or-key",
                                          base_url="http://fake/api/v1/chat/completions"),
                   lambda c: c.generate("hi")),
    "local": (lambda m: m.Local("vllm-model", base_url="http://fake:8000/v1"),
              lambda c: c.generate([{"role": "user", "content": "hi"}], temperature=0.0)),
    "local-legacy": (lambda m: m.Local("vllm-model", base_url="http://fake:8000/v1"),
                     lambda c: c.generate("complete me", use_legacy_api=True, max_tokens=5)),
}


@pytest.mark.parametrize("case", sorted(CLIENT_CASES))
def test_clients_send_and_parse_the_same(case):
    make, call = CLIENT_CASES[case]

    def run(pkg):
        server = FakeServer()
        out = _drive(pkg, make, call, server)
        return server.requests, out

    (jax_requests, jax_out), (requests, out) = _on_both(run)
    assert requests == jax_requests and len(requests) == 1
    assert out == jax_out


def test_srt_single_image_generate(tmp_path):
    from PIL import Image

    Image.new("RGB", (6, 6), (1, 2, 3)).save(tmp_path / "x.png")
    make = CLIENT_CASES["srt"][0]

    def run(pkg):
        server = FakeServer()
        out = _drive(pkg, make, lambda c: c.single_image_generate("what?", str(tmp_path / "x.png")), server)
        return server.requests, out

    jax_out, out = _on_both(run)
    assert out == jax_out and b"image_url" in out[0][0]["body"]


def test_outlines_with_a_schema():
    class Tok:
        def apply_chat_template(self, messages, tokenize, add_generation_prompt):
            return "|".join(m["content"] for m in messages) + "|assistant:"

    def run(pkg):
        server = FakeServer(reply='{"example_0": 2}')
        out = _drive(pkg, lambda m: m.Outlines("m", base_url="http://fake/generate", tokenizer=Tok()),
                     lambda c: c.generate([{"role": "user", "content": "rate"}], schema={"type": "object"}), server)
        return server.requests, out

    jax_out, out = _on_both(run)
    assert out == jax_out and out[1] == {"example_0": 2}


@pytest.mark.parametrize("status,tries", [(500, 2), (429, 2), (404, 1)])
def test_retry_chat_retries_server_errors_only(status, tries, monkeypatch):
    async def no_sleep(_):
        return None

    def run(pkg):
        mod = PACKAGES[pkg]["client"]
        monkeypatch.setattr(mod.asyncio, "sleep", no_sleep)
        server = FakeServer(fail=5, status=status)
        transport = mod.ChatTransport("http://fake")
        transport._client = server.client()
        with pytest.raises(httpx.HTTPStatusError):
            asyncio.run(mod.retry_chat(transport, "m", [{"role": "user", "content": "x"}], max_retries=2))
        recovered = FakeServer(fail=1)
        transport._client = recovered.client()
        out = asyncio.run(mod.retry_chat(transport, "m", [], max_retries=3)) if status != 404 else None
        return len(server.requests), out

    assert _on_both(run) == ((tries, None if status == 404 else "stub reply"),) * 2


def test_create_response_model_and_image_encoding():
    from PIL import Image

    pytest.importorskip("pydantic")
    for pkg in PACKAGES:
        model = PACKAGES[pkg]["client"].create_response_model(3)
        assert model(example_0=1, example_1=2, example_2=3).example_2 == 3
        with pytest.raises(Exception):
            model(example_0="not-an-int", example_1=2, example_2=3)
    img = Image.new("RGB", (5, 3), (9, 8, 7))
    assert client_mod.encode_image_base64(img) == jax_client_mod.encode_image_base64(img)
