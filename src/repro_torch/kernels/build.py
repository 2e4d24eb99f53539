"""Build and load the port's CUDA C++ kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into an
object, all of them at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c <src>.cu    (one per source)
    nvcc -shared -o libkernels.so *.o

The library lands in ``build/cuda/<hash of sources + flags>/`` under the
repository root, so an edited source builds afresh and an unchanged one
is loaded again.  The build happens at the first launch of a kernel, never
at import: machines without ``nvcc`` import every module.  A failed build
raises with ``nvcc``'s output; there is no fallback.

Every C entry point takes its pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``: a bare Python int would be cut to 32
bits) and returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: name -> argtypes (restype is int: the CUDA error code,
# or for flash_decode_smem_bytes a size in bytes)
SIGNATURES = {
    "ssd_intra_chunk_f32": [P, P, P, P, P, I, I, I, I, I, I, P],
    "ssd_intra_chunk_bf16": [P, P, P, P, P, I, I, I, I, I, I, P],
    "flash_decode_f32": [P, P, P, P, P, P, *[I] * 9, F, F, P],
    "flash_decode_bf16": [P, P, P, P, P, P, *[I] * 9, F, F, P],
    "flash_decode_smem_bytes": [I, I, I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
            "built at first launch and need the CUDA toolkit")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds, log):
    """Start every command at once; wait for all; raise on any failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> pathlib.Path:
    """Compile (unless already built) and return the library's path."""
    out = build_dir()
    lib = out / "libkernels.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc, log = _nvcc(), []
    objs = [out / f"{src.stem}.{os.getpid()}.o" for src in _sources()]
    _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(_sources(), objs)], log)
    tmp = out / f"libkernels.{os.getpid()}.so"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]], log)
    (out / "build.log").write_text("\n".join(log))
    os.replace(tmp, lib)          # atomic: a reader never sees half a file
    for obj in objs:
        obj.unlink()
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """nvcc's output of the last build (``-Xptxas -v``: registers, shared
    memory and spills of every kernel)."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({text})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
