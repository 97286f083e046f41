"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a library with a
plain C interface, under ``build/kernels/`` of the checkout, keyed by the
hash of the source and of every header in ``csrc/`` (``*.cuh``, which the
sources include), at first use; it is loaded with ``ctypes``.  A failed
build raises with the compiler's output: nothing falls back.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "build", "source_digest"]

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


def source_digest(source, csrc=CSRC):
    """Build key of ``source``: the hash of its bytes and of every header
    of ``csrc``, so that an edit to a header builds anew."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in sorted(Path(csrc).glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build(source_name):
    """Compile ``csrc/<source_name>`` (once per source content) and return
    the loaded ``ctypes.CDLL``."""
    source = CSRC / source_name
    digest = source_digest(source)
    lib_path = _BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", str(CSRC),
               "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source_name} "
                               f"({res.returncode})\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
