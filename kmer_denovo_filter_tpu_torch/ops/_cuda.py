"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``csrc/`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and links the objects
into one shared library with a plain C interface, loaded with
:mod:`ctypes`: no PyTorch headers, so a cold build takes seconds.  The
build runs at first use and is cached under
``build/kernels/<sha256>/libkdf_torch.so`` inside the package, keyed by
the sources and headers (``csrc/*.cuh``), the compiler flags and
``nvcc --version`` (the pattern of ``htsio/native.py``, minus its
fallback: a build that fails raises).  ``nvcc -Xptxas -v`` output
(registers, shared memory, spills per kernel) is kept beside the
library as ``build.log``.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

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


def headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def build():
    """Compile ``csrc/*.cu`` unless cached; return the library's path."""
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha256()
    for path in sources() + headers():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(COMPILE_FLAGS).encode())
    digest.update(version.encode())
    out_dir = os.path.join(BUILD_DIR, digest.hexdigest())
    lib_path = os.path.join(out_dir, "libkdf_torch.so")
    if os.path.isfile(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
            for src in sources()]
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    log, failed = [], []
    for src, proc in zip(sources(), procs):
        out = proc.communicate()[0]
        log.append(f"== nvcc -c {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} (code {proc.returncode})")
    tmp_path = f"{lib_path}.{tag}"
    if not failed:
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_path,
                              *objs], capture_output=True, text=True)
        log.append(f"== nvcc -shared\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link (code {res.returncode})")
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write("".join(log))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n"
                           + "".join(log))
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
                                                 i32, i32, ptr]
            so.kdf_extract_canonical.restype = i32
            so.kdf_seg_sort.argtypes = [ptr, ptr, ptr, ptr, i64, ptr]
            so.kdf_seg_sort.restype = i32
            so.kdf_seg_dedup.argtypes = [ptr, i64, i32, ptr, ptr, ptr, ptr,
                                         ptr]
            so.kdf_seg_dedup.restype = i32
            so.kdf_seg_dedup_wide.argtypes = [ptr, i64, i32, i32, ptr, ptr,
                                              ptr, ptr, ptr]
            so.kdf_seg_dedup_wide.restype = i32
            so.kdf_build_directory.argtypes = [ptr, i32, i32, i32, i32, ptr,
                                               ptr]
            so.kdf_build_directory.restype = i32
            so.kdf_dir_probe_plan.argtypes = [i64, i32, i32, i32, i32, i32,
                                              i32, ptr]
            so.kdf_dir_probe_plan.restype = i32
            so.kdf_probe_tally.argtypes = [ptr, i64, ptr, i32, ptr, i32, i32,
                                           ptr, i32, i32, i32, ptr]
            so.kdf_probe_tally.restype = i32
            so.kdf_probe_tally_weighted.argtypes = [ptr, ptr, ptr, i64, ptr,
                                                    ptr, i32, i32, ptr, i32,
                                                    i32, i32, ptr]
            so.kdf_probe_tally_weighted.restype = i32
            so.kdf_probe_member.argtypes = [ptr, i64, ptr, i32, ptr, i32, i32,
                                            ptr, ptr, i32, i32, i32, ptr]
            so.kdf_probe_member.restype = i32
            so.kdf_extract_canonical_wide.argtypes = [ptr, ptr, ptr, i32,
                                                      i32, i32, ptr]
            so.kdf_extract_canonical_wide.restype = i32
            so.kdf_probe_tally_wide.argtypes = [ptr, ptr, ptr, i64, ptr, ptr,
                                                i32, i32, i32, ptr, ptr]
            so.kdf_probe_tally_wide.restype = i32
            so.kdf_probe_member_wide.argtypes = [ptr, i64, ptr, ptr, i32, i32,
                                                 i32, ptr, ptr, ptr]
            so.kdf_probe_member_wide.restype = i32
            so.kdf_route.argtypes = [ptr, i64, i32, i32, i32, i32, i32, ptr,
                                     ptr, ptr, ptr, ptr]
            so.kdf_route.restype = i32
            so.kdf_words_to_keys.argtypes = [ptr, i64, i32, i32, i32, ptr, ptr]
            so.kdf_words_to_keys.restype = i32
            so.kdf_sort_count_aux.argtypes = [i32]
            so.kdf_sort_count_aux.restype = i64
            so.kdf_sort_count.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr,
                                          ptr, ptr, ptr, ptr, ptr]
            so.kdf_sort_count.restype = i32
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
