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


def _code(name: str) -> str:
    """A source with its comments stripped."""
    return "\n".join(line.split("//")[0] for line in kernels.CUDA_SOURCES[name].read_text().splitlines())


def test_the_forward_source_is_a_wgmma_kernel_on_the_hopper_header():
    code = _code("flash_attention")
    assert f'#include "{HEADER}"' in code
    # S = qs K^T: qs from registers, K read K-major from its ring tile.
    assert re.search(r"wgmma_rs<KT, 0>\(s, qa\[kk\], desc_k_major<KT>\(Ks, kk\)", code)
    # O += P V: P from registers, V read MN-major from its row-major tile.
    assert re.search(r"wgmma_rs<HD, 1>\(acc, pa\[kq\], desc_mn_major<KT>\(Vs, kq\)", code)
    assert "acc_to_a(" in code
    # K and V reach shared memory through the cp.async ring.
    assert re.search(r"load_tile<KT, HD, \w+>\([^;]*, kp, j \* KT, S,", code)
    assert re.search(r"load_tile<KT, HD, \w+>\([^;]* \+ L::KV_TILE, vp, j \* KT, S,", code)
    assert re.search(r"cp_async_wait<\d>\(\);\s*fence_proxy_async\(\);", code)


def test_the_forward_is_warp_specialised():
    """A producer warpgroup fills the ring and gives its registers to the
    consumers; named barriers pass each stage between them, so no consumer
    waits on __syncthreads for the other."""
    code = _code("flash_attention")
    assert "setmaxnreg.dec.sync.aligned" in code and "setmaxnreg.inc.sync.aligned" in code
    assert "bar.sync %0, %1" in code and "bar.arrive %0, %1" in code
    loop = code[code.index("bar_sync(full_id(") :]
    assert "__syncthreads" not in loop
    # Every named barrier id fits the 16 a block has (0 is __syncthreads').
    stages = int(re.search(r"constexpr int STAGES = (\d+);", code).group(1))
    assert 1 + 3 * stages + 1 <= 15


def test_the_forward_ring_has_at_least_two_stages():
    stages = re.search(r"constexpr int STAGES = (\d+);", _code("flash_attention"))
    assert stages and int(stages.group(1)) >= 2


def test_the_forward_source_has_no_mma_sync_no_transposed_v_and_no_atomics():
    code = _code("flash_attention")
    assert "mma.sync" not in code and "mma_bf16" not in code
    # V is never stored transposed: every shared-memory write of a tile is
    # a load_tile copy, and no array indexes V by column first.
    assert "Vt" not in code and "__shared__ __align__" not in code
    assert "atomic" not in code


def test_fwd_resources_keeps_the_contract_of_bwd_resources():
    import inspect

    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    for fn in (fa.fwd_resources, fa.bwd_resources):
        sig = inspect.signature(fn)
        assert list(sig.parameters) == ["hd"] and sig.return_annotation in (dict, "dict")
    assert re.search(r"int flash_attention_fwd_resources\(int hd, int\* out\)", _code("flash_attention"))
    assert re.search(r"int flash_attention_bwd_resources\(int hd, int\* out\)", _code("flash_attention_bwd"))
    assert "flash_attention_fwd_resources" in inspect.getsource(fa.fwd_resources)


def test_the_backward_source_includes_the_hopper_header():
    code = "\n".join(
        line.split("//")[0] for line in kernels.CUDA_SOURCES["flash_attention_bwd"].read_text().splitlines()
    )
    assert f'#include "{HEADER}"' in code
    assert "wgmma_rs" in code and "wgmma_ss" in code and "load_tile" in code
    # Deterministic: no atomics anywhere in the kernels.
    assert "atomic" not in code
