"""Build the CUDA sources under csrc/ at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), cached in
`build/kernels/` beside the package and keyed by a hash of the source and
the flags. Kernels take device pointers and the CUDA stream as integers
from `tensor.data_ptr()` and `torch.cuda.current_stream().cuda_stream`.

Nothing here runs at import: the CPU tests import every module, and only a
launch on a CUDA tensor reaches `library()`. `build_all()` starts one nvcc
per source at once (used by chip_smoke.py to build before it measures).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
#: the operator's kernel cache: a directory here overrides the default
#: (and the warm-restart cache of tune/compile_cache.py never overrides it)
ENV_BUILD_DIR = "W2V_KERNEL_BUILD_DIR"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
BUILD_DIR = Path(os.environ.get(ENV_BUILD_DIR) or DEFAULT_BUILD_DIR)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point, by library
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "fused_step": {
        "w2v_fused_grad_core": (
            _I,
            [_P, _I, _P, _P, _P, _P, _P, _P,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
        ),
        "w2v_slab_scatter": (_I, [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "w2v_slab_scatter_gathered": (
            _I,
            [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
        ),
        "w2v_row_sq_norms": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
        "w2v_scatter_stage_terms": (_I, []),
        "w2v_grad_core_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I, _I, _I]),
        "w2v_grad_core_blocks_per_sm": (_I, [_I, _I, _I, _I, _I, _I, _I, _I]),
        "w2v_error_string": (ctypes.c_char_p, [_I]),
    },
    "overlap": {
        "w2v_overlap_add": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
        "w2v_error_string": (ctypes.c_char_p, [_I]),
    },
    "band_core": {
        "w2v_band_core": (
            _I,
            [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
        ),
        "w2v_band_core_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I, _I, _I]),
        "w2v_band_core_blocks_per_sm": (_I, [_I, _I, _I, _I, _I, _I, _I, _I]),
        "w2v_error_string": (ctypes.c_char_p, [_I]),
    },
    "row_sum": {
        "w2v_ordered_row_sum": (_I, [_P, _P, _P, _P, _I, _P]),
        "w2v_row_sum_stage": (_I, []),
        "w2v_error_string": (ctypes.c_char_p, [_I]),
    },
    "runs": {
        "w2v_find_runs": (_I, [_P, _I, _P, _P, _P]),
        "w2v_long_run": (_I, []),
        "w2v_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: nvcc's -Xptxas -v report per library (registers, shared memory, spills)
PTXAS_REPORTS: Dict[str, str] = {}
#: the sources this process ran nvcc for (a cache hit runs none)
NVCC_RUNS: List[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build on a machine with the CUDA toolkit"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for csrc/<name>.cu unless its library is cached."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    proc.w2v_tmp = tmp  # type: ignore[attr-defined]
    proc.w2v_out = out  # type: ignore[attr-defined]
    NVCC_RUNS.append(name)
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stderr}{stdout}"
        )
    PTXAS_REPORTS[name] = stderr + stdout
    os.replace(proc.w2v_tmp, proc.w2v_out)  # atomic: no half-written .so


def library_names() -> List[str]:
    """The current sources' library file names (source + header hash)."""
    return [_target(p.stem).name for p in sorted(CSRC.glob("*.cu"))]


def set_build_dir(path) -> Path:
    """Point the library lookup (and any build) at `path`; libraries
    already loaded in this process stay loaded. Returns the old dir."""
    global BUILD_DIR
    old, BUILD_DIR = BUILD_DIR, Path(path)
    return old


def build_all() -> None:
    """Build every csrc/*.cu, one nvcc process per source, all started
    together."""
    procs = [(p.stem, _start(p.stem)) for p in sorted(CSRC.glob("*.cu"))]
    for n, p in procs:
        _finish(n, p)


def library(name: str = "fused_step") -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.w2v_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
