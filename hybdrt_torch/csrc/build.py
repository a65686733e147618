"""Build, load and launch the CUDA kernels of the port.

The sources under ``hybdrt_torch/csrc`` are compiled with ``nvcc`` at first
use, one ``nvcc`` per source, all started together, and linked into one
shared library with a plain C interface in ``hybdrt_torch/_build/`` (listed in
``.gitignore``). The library's name carries a hash of the sources, headers
and flags, so an edited kernel is rebuilt and a fresh checkout builds its own.
Loading goes through ``ctypes``; nothing here includes PyTorch's headers,
which keeps the build to seconds.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("chol_lane.cu", "ip_lane.cu", "chol_layouts.cu")
HEADERS = ("lane_common.cuh", "lane_regs.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIB = None
_FNS = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def find_nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels build only where the CUDA toolkit is installed)")


def library_path():
    """Path of the built library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libhybdrt_torch-{h.hexdigest()[:16]}.so"


def build():
    """Compile the kernels if no library for the current sources exists.

    Returns the library path. The compiler's output (``-Xptxas=-v``: registers,
    shared memory and spills per kernel) is kept beside it as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{tag}.tmp")
    try:
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log[-4000:]}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        lib.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
        # atomic: concurrent builds of the same sources race harmlessly
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib


def load():
    """Build if needed and load the library (once per process)."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB


def _function(name, dtype, n_ptrs, n_ints):
    key = (name, dtype)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def launch(name, tensors, ints, device):
    """Launch the kernel ``{name}_{f32|f64}`` (by the first tensor's dtype) on
    the current stream of ``device``. Its C arguments are the tensors'
    pointers, then ``ints``, then the stream. Raises on a refused launch."""
    fn = _function(name, tensors[0].dtype, len(tensors), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
