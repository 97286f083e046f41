"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a library with a
plain C interface, under ``build/kernels/`` of the checkout, keyed by the
hash of the source, at first use; it is loaded with ``ctypes``.  A failed
build raises with the compiler's output: nothing falls back.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "build"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            cand = Path(CUDA_HOME) / "bin" / "nvcc"
            nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: building the kernels in "
                           "professad_tpu_torch/csrc needs the CUDA toolkit")
    return nvcc


@functools.lru_cache(maxsize=None)
def build(source_name):
    """Compile ``csrc/<source_name>`` (once per source content) and return
    the loaded ``ctypes.CDLL``."""
    source = CSRC / source_name
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source_name} "
                               f"({res.returncode})\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
