"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for sm_90a into its own shared library with
a plain C interface, loaded through `ctypes`: a build takes seconds, against
minutes for an extension that includes PyTorch's headers.  Libraries land in
`multimodal_sae_tpu_torch/_build/` (git-ignored), named by a hash of their
source and of the headers beside it (`csrc/*.cuh`, which are no libraries of
their own), so an edited source or header builds anew and a stale library is
never loaded.
`build()` starts one `nvcc` per missing library, all at once, and waits for
them; `load(name)` builds on first use.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
CUDA_SOURCES = {
    "block_max": CSRC / "block_max.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
    "gather_rows": CSRC / "gather_rows.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_libs: Dict[str, ctypes.CDLL] = {}


def library_path(src: Path) -> Path:
    """Where the library built from `src` lives, named by its content and
    that of every header (`*.cuh`) beside it, which a source may include."""
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet, one
    `nvcc` process each, in parallel.  Returns {name: compiler log} for what
    was built (ptxas register and spill counts); raises on any failure."""
    names = list(CUDA_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = CUDA_SOURCES[name]
        out = library_path(src)
        if out.exists():
            continue
        # Compile to a per-process name and rename into place: concurrent
        # builds never expose a half-written library.
        tmp = out.with_suffix(f".so.build.{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(CUDA_SOURCES[name])))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
