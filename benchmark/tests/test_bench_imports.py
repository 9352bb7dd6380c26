"""What the benchmark's modules import, by whole top-level module names:
`multimodal_sae_tpu_torch` begins with the JAX package's name and is
another package."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

FILES = sorted(p for p in harness.BENCH_DIR.rglob("*.py") if "tests" not in p.parts[len(harness.BENCH_DIR.parts):])


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_no_jax(path):
    assert not set(imported_tops(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert "multimodal_sae_tpu_torch" not in set(imported_tops(path))


def test_forbidden_names_compare_whole():
    port = ["multimodal_sae_tpu_torch", "multimodal_sae_tpu_torch.features.cache", "jaxtyping", "flaxen"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules(port + ["jax.numpy", "multimodal_sae_tpu.ops"]) == ["jax", "multimodal_sae_tpu"]
