"""The port's CUDA build helper (`multimodal_sae_tpu_torch/kernels.py`) on the
CPU, without nvcc: a library's name follows its source and every header
beside it, so an edited source or header never loads a stale library; every
CUDA source is built; and each source's head says which TPU kernel it
replaces and what bounds it on the card."""

import hashlib
import re
import shutil

import pytest

from multimodal_sae_tpu_torch import kernels

HEADER = "sm90.cuh"


def _copy_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    return csrc


def _head(name: str) -> str:
    """The comment block a source opens with."""
    lines = kernels.CUDA_SOURCES[name].read_text().splitlines()
    head = []
    for line in lines:
        if not line.startswith("//"):
            break
        head.append(line[2:].strip())
    return " ".join(head)


@pytest.mark.parametrize("name", sorted(kernels.CUDA_SOURCES))
def test_editing_a_header_changes_every_library_path(tmp_path, name):
    csrc = _copy_csrc(tmp_path)
    src = csrc / kernels.CUDA_SOURCES[name].name
    before = kernels.library_path(src)
    # The copy names the library as the package's own source does.
    assert before == kernels.library_path(kernels.CUDA_SOURCES[name])
    header = csrc / HEADER
    header.write_text(header.read_text() + "\n// edited\n")
    after = kernels.library_path(src)
    assert after != before
    assert after.parent == kernels.BUILD_DIR and after.name.startswith(f"lib{src.stem}-")


@pytest.mark.parametrize("name", sorted(kernels.CUDA_SOURCES))
def test_editing_a_source_changes_its_library_path(tmp_path, name):
    csrc = _copy_csrc(tmp_path)
    src = csrc / kernels.CUDA_SOURCES[name].name
    before = kernels.library_path(src)
    src.write_text(src.read_text() + "\n// edited\n")
    assert kernels.library_path(src) != before


def test_a_new_header_changes_the_library_path(tmp_path):
    csrc = _copy_csrc(tmp_path)
    src = csrc / "flash_attention_bwd.cu"
    before = kernels.library_path(src)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kernels.library_path(src) != before


def test_a_source_without_headers_is_named_by_its_content_alone(tmp_path):
    # The host extractor (native/coo.cpp) has no header beside it: its
    # library keeps the name it had before headers were hashed.
    src = tmp_path / "coo.cpp"
    src.write_text("int f() { return 1; }\n")
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    assert kernels.library_path(src) == kernels.BUILD_DIR / f"libcoo-{digest}.so"


def test_every_cuda_source_is_built_and_no_header_is():
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    assert sources == sorted(p.name for p in kernels.CUDA_SOURCES.values())
    assert all(p.exists() and p.parent == kernels.CSRC for p in kernels.CUDA_SOURCES.values())
    assert (kernels.CSRC / HEADER).exists()
    assert not any(p.suffix == ".cuh" for p in kernels.CUDA_SOURCES.values())


@pytest.mark.parametrize("name", sorted(kernels.CUDA_SOURCES))
def test_source_head_names_the_tpu_kernel_it_replaces_and_its_bound(name):
    head = _head(name)
    assert re.search(r"Replaces .*Pallas|Replaces .*pallas", head), head[:200]
    assert re.search(r"Bound on an H100: .*(989 TFLOP/s|3\.35 TB/s)", head), head[:400]


def test_the_backward_source_includes_the_hopper_header():
    code = "\n".join(
        line.split("//")[0] for line in kernels.CUDA_SOURCES["flash_attention_bwd"].read_text().splitlines()
    )
    assert f'#include "{HEADER}"' in code
    assert "wgmma_rs" in code and "wgmma_ss" in code and "load_tile" in code
    # Deterministic: no atomics anywhere in the kernels.
    assert "atomic" not in code
