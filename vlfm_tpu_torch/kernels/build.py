"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers);
``csrc/*.cuh`` holds device helpers they share.
Each source compiles to an object in its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links them into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <build>/<hash>/<name>.o csrc/<name>.cu
    nvcc -shared -o <build>/<hash>/libvlfm_kernels.so <build>/<hash>/*.o

The output lands in ``vlfm_tpu_torch/build/<hash>/``, keyed by a hash of
the sources, the headers and the flags, so an edited source rebuilds and
an unchanged one loads the existing library. A failed build raises with
nvcc's output. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIB_NAME = "libvlfm_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return sources


def _source_hash(sources: list[Path]) -> str:
    """Of the flags, the sources and the headers they share (``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any that fail."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists."""
    sources = _sources()
    out_dir = BUILD_DIR / _source_hash(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objs)])
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vlfm_layer_norm.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, p]
    lib.vlfm_layer_norm.restype = i
    lib.vlfm_add_layer_norm.argtypes = [p, p, i, p, p, p, p, i, i, ctypes.c_float, i, p]
    lib.vlfm_add_layer_norm.restype = i
    lib.vlfm_layer_norm_max_d.argtypes = []
    lib.vlfm_layer_norm_max_d.restype = i
    lib.vlfm_mbconv_chain.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
    lib.vlfm_mbconv_chain.restype = i
    f = ctypes.c_float
    lib.vlfm_attention.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, f, f,
                                   i, i, i, i, i, i, i, i, p]
    lib.vlfm_attention.restype = i
    lib.vlfm_deform_gather.argtypes = [p, p, p, p, ctypes.POINTER(i), i, i, i, i, i, i, i, i, i,
                                       i, i, i, i, i, i, i, i, p]
    lib.vlfm_deform_gather.restype = i
    lib.vlfm_flood.argtypes = [p, p, p, i, i, i, i, i, i, i, p, p, p, p]
    lib.vlfm_flood.restype = i
    lib.vlfm_label.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p]
    lib.vlfm_label.restype = i
    lib.vlfm_cluster_sync.argtypes = [i, i, p]
    lib.vlfm_cluster_sync.restype = i
    return lib
