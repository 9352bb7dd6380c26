"""ctypes bindings for the host-side COO kernels (`native/coo.cpp`, a copy of
the JAX package's), built with g++ on first use into the port's build
directory, with numpy fallbacks (multimodal_sae_tpu/native/coo.py).

`MMSAE_DISABLE_NATIVE=1` forces the numpy paths, and a failed build falls
back to them, as in the JAX package; both give the same triples and
partitions."""

from __future__ import annotations

import ctypes
import logging
import mmap
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..kernels import BUILD_DIR, library_path

_SRC = Path(__file__).resolve().parent / "coo.cpp"

logger = logging.getLogger(__name__)

_lib = None
_build_failed = False


def populated_empty(shape, dtype) -> np.ndarray:
    """`np.empty` with its pages pre-faulted (MAP_POPULATE): first-touch
    faults on fresh GB-scale buffers otherwise dominate the host-side
    extraction.  Falls back to touch-by-fill where MAP_POPULATE is absent."""
    dtype = np.dtype(dtype)
    n = int(np.prod(shape))
    nbytes = max(1, n * dtype.itemsize)
    populate = getattr(mmap, "MAP_POPULATE", 0)
    if populate and n:
        try:
            m = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | populate)
            return np.frombuffer(m, dtype=dtype, count=n).reshape(shape)
        except (ValueError, OSError):
            pass
    a = np.empty(shape, dtype=dtype)
    a.fill(0)
    return a


def _build(lib_path: Path) -> None:
    # Per-process temp name + atomic rename: concurrent builds never
    # expose (or truncate under a reader) a half-written library.
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".so.build.{os.getpid()}")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SRC.name} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib_path)


def _load() -> Optional[ctypes.CDLL]:
    """The library, or None for the numpy paths: when `MMSAE_DISABLE_NATIVE`
    is "1", or when building or loading it failed (tried once a process)."""
    global _lib, _build_failed
    if os.environ.get("MMSAE_DISABLE_NATIVE") == "1" or _build_failed:
        return None
    if _lib is not None:
        return _lib
    lib_path = library_path(_SRC)
    try:
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (RuntimeError, OSError) as e:
        _build_failed = True
        logger.warning(f"native COO extraction unavailable, using the numpy paths: {e}")
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    for name, idx_p in (("coo_extract_topk", i64p), ("coo_extract_topk_i32", i32p)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            f32p, idx_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, i64p, ctypes.c_int64,
            ctypes.c_int64,
            i64p, f32p,
        ]
    lib.coo_partition_splits.restype = ctypes.c_int64
    lib.coo_partition_splits.argtypes = [
        i64p, f32p, ctypes.c_int64,
        i64p, ctypes.c_int64,
        i64p, i64p, f32p,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native library is in use: built (or buildable) and not
    disabled by `MMSAE_DISABLE_NATIVE=1`, which is read at each call."""
    return _load() is not None


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def coo_extract_topk(
    vals: np.ndarray,
    idx: np.ndarray,
    threshold: float = 1e-5,
    filter_ids: Optional[np.ndarray] = None,
    row_offset: int = 0,
    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """(B, S, k) top-k values/ids -> (locations (N, 3) int64, activations (N,)
    float32) of the entries with |value| > threshold, in row-major order.

    With `out=(locations (cap, 3) int64, activations (cap,) f32)` the
    triples go straight into the caller's buffers and the count is
    returned."""
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    use_i32 = np.asarray(idx).dtype == np.int32
    idx = np.ascontiguousarray(idx, dtype=np.int32 if use_i32 else np.int64)
    if vals.ndim != 3 or idx.shape != vals.shape:
        raise ValueError(f"vals and idx must share one (B, S, k) shape, got {vals.shape}, {idx.shape}")
    B, S, K = vals.shape
    cap = B * S * K
    if out is not None:
        out_loc, out_act = out
        if not (out_loc.flags.c_contiguous and out_act.flags.c_contiguous):
            raise ValueError("out buffers must be C-contiguous")
        if out_loc.dtype != np.int64 or out_act.dtype != np.float32:
            raise TypeError("out buffers must be int64 locations and float32 activations")
        if out_loc.shape[0] < cap or out_act.shape[0] < cap:
            raise ValueError(f"out buffers hold fewer than {cap} entries")
    if lib is None:
        mask = np.abs(vals) > threshold
        if filter_ids is not None:
            mask &= np.isin(idx, filter_ids)
        b, s, j = np.nonzero(mask)
        n = b.shape[0]
        if out is None:
            out_loc, out_act = np.empty((n, 3), dtype=np.int64), np.empty((n,), dtype=np.float32)
        out_loc[:n, 0] = b + row_offset
        out_loc[:n, 1] = s
        out_loc[:n, 2] = idx[b, s, j]
        out_act[:n] = vals[mask]
        return n if out is not None else (out_loc, out_act)
    if out is None:
        out_loc = populated_empty((cap, 3), np.int64)
        out_act = populated_empty((cap,), np.float32)
    if filter_ids is not None:
        filt = np.ascontiguousarray(np.sort(np.asarray(filter_ids, dtype=np.int64)))
        fptr, flen = _i64p(filt), len(filt)
    else:
        filt, fptr, flen = None, ctypes.cast(None, ctypes.POINTER(ctypes.c_int64)), 0
    fn = lib.coo_extract_topk_i32 if use_i32 else lib.coo_extract_topk
    idx_p = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32 if use_i32 else ctypes.c_int64))
    n = fn(
        _f32p(vals), idx_p, B, S, K,
        ctypes.c_float(threshold), fptr, flen,
        row_offset, _i64p(out_loc), _f32p(out_act),
    )
    if out is not None:
        return n
    return out_loc[:n].copy(), out_act[:n].copy()


def coo_partition_splits(
    locations: np.ndarray,
    activations: np.ndarray,
    boundaries: np.ndarray,
    scratch: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Partition a COO stream by feature ranges [boundaries[i],
    boundaries[i+1]); a list of (locations_i, activations_i) per split,
    stable within each split.  `scratch` (locations (cap, 3) int64,
    activations (cap,) f32), when large enough, holds the output: the
    returned views alias it, so consume them before the next call.  The
    numpy path returns copies."""
    lib = _load()
    locations = np.ascontiguousarray(locations, dtype=np.int64)
    activations = np.ascontiguousarray(activations, dtype=np.float32)
    boundaries = np.ascontiguousarray(boundaries, dtype=np.int64)
    n_splits = len(boundaries) - 1
    N = len(locations)
    if locations.shape != (N, 3) or activations.shape != (N,):
        raise ValueError(f"need locations (N, 3) and activations (N,), got {locations.shape}, {activations.shape}")
    if lib is None:
        feats = locations[:, 2]
        return [
            (locations[m], activations[m])
            for m in ((feats >= boundaries[i]) & (feats < boundaries[i + 1]) for i in range(n_splits))
        ]
    counts = np.zeros(n_splits, dtype=np.int64)
    if (
        scratch is not None
        and scratch[0].ndim == 2
        and scratch[0].shape[0] >= N
        and scratch[0].shape[1] == 3
        and scratch[1].shape[0] >= N
        and scratch[0].flags.c_contiguous
        and scratch[1].flags.c_contiguous
        and scratch[0].dtype == np.int64
        and scratch[1].dtype == np.float32
    ):
        out_loc, out_act = scratch[0][:N], scratch[1][:N]
    else:
        out_loc = populated_empty(locations.shape, np.int64)
        out_act = populated_empty(activations.shape, np.float32)
    lib.coo_partition_splits(
        _i64p(locations), _f32p(activations), N,
        _i64p(boundaries), n_splits,
        _i64p(counts), _i64p(out_loc), _f32p(out_act),
    )
    out, start = [], 0
    for i in range(n_splits):
        end = start + int(counts[i])
        out.append((out_loc[start:end], out_act[start:end]))
        start = end
    return out
