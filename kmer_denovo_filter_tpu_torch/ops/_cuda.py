"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``csrc/`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with :mod:`ctypes` —
no PyTorch headers, so a cold build takes seconds.  The build runs at
first use and is cached under ``build/kernels/<sha256>/libkdf_torch.so``
inside the package, keyed by the sources, the compiler flags and
``nvcc --version`` (the pattern of
``kmer_denovo_filter_tpu/htsio/native.py``, minus its fallback: a
build that fails raises).  ``nvcc -Xptxas -v`` output (registers,
shared memory, spills per kernel) is kept beside the library as
``build.log``.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "kmer_denovo_filter_tpu_torch are built at first use")
    return nvcc


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build():
    """Compile ``csrc/*.cu`` unless cached; return the library's path."""
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha256()
    for path in sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(version.encode())
    out_dir = os.path.join(BUILD_DIR, digest.hexdigest())
    lib_path = os.path.join(out_dir, "libkdf_torch.so")
    if os.path.isfile(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp_path, *sources()],
                         capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stderr}")
    os.replace(tmp_path, lib_path)
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            so.kdf_extract_canonical.argtypes = [ptr, ptr, ptr, i32, i32,
                                                 i32, ptr]
            so.kdf_extract_canonical.restype = i32
            so.kdf_probe_tally.argtypes = [ptr, i64, ptr, i32, ptr, ptr]
            so.kdf_probe_tally.restype = i32
            so.kdf_cuda_error_string.argtypes = [i32]
            so.kdf_cuda_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(err, kernel):
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        text = lib().kdf_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({text})")


def stream_of(tensor):
    """PyTorch's current stream on *tensor*'s device, as a pointer."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
