"""The tiled design of kernel K2's decode mode
(`multimodal_sae_tpu_torch/csrc/gather_rows.cu`) on the CPU, without nvcc.

The source: the tiled decode stages rows in shared memory with cp.async,
no mode uses atomics, and the decode's chain stays `fmaf` from 0.f in step
order (the splice mode is held to its bits).  The host side: the
pre-pass's plain version (`tile_union_plain`), which the card's pre-pass is
held to bit for bit by chip_smoke.py, against a numpy count of each tile's
rows; the distinct-rows statistic chip_smoke.py prints
(`tile_union_sizes`); and the wrappers, whose CPU path is the plain version
and counts no launch."""

import re

import numpy as np
import pytest
import torch

from multimodal_sae_tpu_torch import kernels
from multimodal_sae_tpu_torch.ops import gather_rows as gr


def _code() -> str:
    """gather_rows.cu with its comments stripped."""
    return "\n".join(line.split("//")[0] for line in kernels.CUDA_SOURCES["gather_rows"].read_text().splitlines())


def _body(name: str) -> str:
    """The text of kernel `name`, from its name to the next kernel's."""
    code = _code()
    at = code.index(f" {name}(")
    end = code.find("__global__", at)
    return code[at:end if end > 0 else len(code)]


def test_the_tiled_decode_stages_rows_in_shared_memory_with_cp_async():
    body = _body("decode_tile_kernel")
    assert "extern __shared__" in body
    # Staged rows arrive through stage_slices, whose copies are cp.async.
    assert "stage_slices(" in body
    assert "cp_async_wait<" in body and "__syncthreads();" in body
    stage = _code()[_code().index("void stage_slices("):]
    assert "sm90::cp_async16(" in stage[:stage.index("\n}")]
    assert '#include "sm90.cuh"' in _code()


def test_the_source_has_no_atomics_and_no_tensor_core_product():
    code = _code()
    assert "atomic" not in code
    assert "wgmma" not in code and "mma.sync" not in code


def test_the_decode_chain_is_fmaf_from_zero_in_step_order():
    code = _code()
    add = code[code.index("struct Vec<float>"):]
    add = add[add.index("static void add("):add.index("}", add.index("static void add("))]
    assert "fmaf(s, f[i], acc[i])" in add
    body = _body("decode_tile_kernel")
    # The accumulators start at 0.f; chunks in order, steps of a chunk in order.
    assert re.search(r"for \(int i = 0; i < E; \+\+i\) acc\[i\] = 0\.f;", body)
    assert re.search(r"for \(int ch = 0; ch < chunks; \+\+ch\)", body)
    assert re.search(r"for \(int u = 0; u < DJ; \+\+u\)\s*\n\s*if \(e\[u\]\.x != INVALID\) Vec<T>::add\(acc,", body)
    # The direct path is the first design's chain.
    direct = _body("gather_decode_kernel")
    assert re.search(r"for \(int j = 0; j < nj; \+\+j\)", direct) and "Vec<T>::add(acc[u], s, wr[c])" in direct


def test_the_wrapper_never_falls_back_on_a_cuda_tensor():
    import inspect

    for fn in (gr.gather_decode, gr.decode_dvals, gr.tile_union):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src


def _numpy_tiles(idx: np.ndarray, L: int, tile: int):
    """Per tile: {row: number of its pairs}, over rows in [0, L)."""
    out = []
    for t0 in range(0, idx.shape[0], tile):
        rows, counts = np.unique(idx[t0:t0 + tile][(idx[t0:t0 + tile] >= 0) & (idx[t0:t0 + tile] < L)],
                                 return_counts=True)
        out.append(dict(zip(rows.tolist(), counts.tolist())))
    return out


CASES = {  # name: (N, k, L, tile, cap)
    "topk_like": (70, 24, 300, 8, 40),
    "ragged_last_tile": (77, 37, 1000, 32, 128),
    "cap_above_union": (20, 16, 64, 8, 500),
    "cap_zero": (33, 8, 100, 4, 0),
    "heavy_repeats": (64, 64, 6, 32, 3),
}


def _case_idx(name):
    N, k, L, tile, cap = CASES[name]
    rng = np.random.default_rng(len(name))
    if name == "topk_like":  # a popular head and a long tail, distinct within a token
        p = 1.0 / np.arange(1, L + 1) ** 1.1
        idx = np.stack([rng.choice(L, size=k, replace=False, p=p / p.sum()) for _ in range(N)])
    else:
        idx = rng.integers(0, L, size=(N, k))
    idx[0, 0], idx[-1, -1] = -1, L + 3  # rows outside W
    return idx.astype(np.int32), L, tile, cap


@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_union_plain_against_a_numpy_count(name):
    idx, L, tile, cap = _case_idx(name)
    code, rows, info = gr.tile_union(torch.from_numpy(idx), L, tile, cap)
    code, rows, info = code.numpy(), rows.numpy(), info.numpy()
    for t, counts in enumerate(_numpy_tiles(idx, L, tile)):
        seg, cseg = idx[t * tile:(t + 1) * tile], code[t * tile:(t + 1) * tile]
        staged = min(len(counts), cap)
        # The staged rows: the `cap` most used (counted up to USE_CAP), ties by row, listed in row order.
        ranked = sorted(counts, key=lambda r: (-min(counts[r], gr.USE_CAP), r))[:staged]
        assert rows[t, :staged].tolist() == sorted(ranked)
        cover = sum(counts[r] for r in ranked)
        n_valid = sum(counts.values())
        assert info[t].tolist() == [staged, int(n_valid > 0 and cover * 100 >= gr.MIN_COVER * n_valid),
                                    len(counts), cover]
        # Each pair's code names its row: a staged slot, -(row + 1), or INVALID.
        valid = (seg >= 0) & (seg < L)
        assert (cseg[~valid] == gr.INVALID).all()
        back = np.where(cseg >= 0, rows[t][np.clip(cseg, 0, None)], -(cseg.astype(np.int64) + 1))
        assert (back[valid] == seg[valid]).all()
        assert set(np.unique(seg[valid][cseg[valid] >= 0]).tolist()) == set(ranked)


def test_tile_union_refuses_what_the_kernel_cannot_take():
    idx = torch.zeros(4, 300, dtype=torch.int32)
    with pytest.raises(ValueError):
        gr.tile_union(idx, 10, 32, 8)  # 32 * 300 pairs > TILE_PAIRS
    with pytest.raises(ValueError):
        gr.tile_union(idx.float(), 10, 1, 8)
    with pytest.raises(ValueError):
        gr.tile_union(idx, 10, 1, -1)


@pytest.mark.parametrize("tile", [1, 8, 16, 32, 64])
def test_tile_union_sizes_counts_each_tiles_distinct_rows(tile):
    rng = np.random.default_rng(tile)
    idx = rng.integers(0, 500, size=(203, 16)).astype(np.int32)
    got = gr.tile_union_sizes(torch.from_numpy(idx), tile).numpy()
    want = [len(np.unique(idx[t0:t0 + tile])) for t0 in range(0, idx.shape[0], tile)]
    assert got.tolist() == want


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_the_cpu_paths_are_the_plain_versions_and_count_nothing(w_dtype):
    rng = np.random.default_rng(3)
    W = torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32)).to(w_dtype)
    idx = torch.from_numpy(rng.integers(0, 300, size=(40, 32)).astype(np.int32))
    vals = torch.from_numpy(rng.random((40, 32)).astype(np.float32)).to(w_dtype)
    g = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    before = (gr.launches, gr.dvals_launches)
    assert torch.equal(gr.gather_decode(idx, vals, W), gr.gather_decode_plain(idx, vals, W))
    assert torch.equal(gr.decode_dvals(g, idx, W, torch.float32), gr.decode_dvals_plain(g, idx, W, torch.float32))
    assert (gr.launches, gr.dvals_launches) == before
