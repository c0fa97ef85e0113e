"""Build the port's CUDA kernels from the sources in this package and bind
them with ctypes. Plays the role of ``kaolin_tpu/native/build.py``.

Every ``kaolin_tpu_torch/**/csrc/*.cu`` goes into ONE shared library with a
plain C interface. No source includes PyTorch's headers, so ``nvcc`` takes
seconds, not the minutes of ``torch.utils.cpp_extension.load``; one ``nvcc``
per source runs at once, then one links. The library is written to
``build/kaolin_tpu_torch/<hash>/`` at the repository root; the hash covers
the sources, the headers and the flags, so an edit rebuilds. It is built at
first use, never at import.

Conventions of the C entries: every pointer and the stream are passed as
``c_void_p``; each entry launches on the stream it is given and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
_ROOT = _PKG.parent

# --fmad=false: no multiply-add contraction, so each kernel rounds op for op
# like its plain PyTorch version. The winner search must reproduce the plain
# face ids exactly (shared edges tie in z to the last bit), and the soft
# mask's backward must see the same ties among its 6 distance candidates.
# Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_LIB_NAME = "libkaolin_tpu_torch.so"
_lock = threading.Lock()
_lib = None


def sources():
    """The CUDA translation units compiled into the library."""
    return sorted(_PKG.glob("**/csrc/*.cu"))


def find_nvcc():
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA toolkit is needed to build the kaolin_tpu_torch "
        "kernels")


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_PKG.glob("**/csrc/*.cu*")):
        h.update(str(src.relative_to(_PKG)).encode())
        h.update(src.read_bytes())
    build_dir = _ROOT / "build" / "kaolin_tpu_torch" / h.hexdigest()[:16]
    return build_dir / _LIB_NAME


def _run(cmds):
    """Run the commands at once, wait for all; raise on the first that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError(failed[0])


def build():
    """Compile the library unless it is already built; return its path."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{src.parent.parent.name}_{src.stem}.{tag}.o")
            for src in sources()]
    tmp = so.with_name(f"{_LIB_NAME}.{tag}")
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources(), objs)])
        _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
    finally:   # a failed compile or link leaves nothing behind
        for leftover in (*objs, tmp):
            leftover.unlink(missing_ok=True)
    return so


def library():
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kaolin_cuda_error_string.argtypes = [ctypes.c_int]
            lib.kaolin_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def function(name, argtypes):
    """The C entry ``name`` with its ``argtypes`` declared; returns int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(status, name):
    """Raise if a C entry reported a CUDA error (launch refused, bad
    configuration, or a fault from earlier work on the device)."""
    if status != 0:
        msg = library().kaolin_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def require(t, name, shape, dtype):
    """Check what a kernel takes: a contiguous CUDA tensor of one dtype and
    shape."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream(t):
    """PyTorch's current stream on ``t``'s device, as the C entries take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
