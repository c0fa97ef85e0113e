"""Build the native host library (g++ → shared object) from
``csrc/kaolin_native.cpp``. Counterpart of ``kaolin_tpu/native/build.py``.

The library goes to ``build/kaolin_tpu_torch/native/<hash>/`` at the
repository root, never into the package; the hash covers the source, the
flags and ``g++ --version``, so an edit or another compiler rebuilds. The
flags are the JAX package's, so that floating-point contraction (and with
it every ``check_sign`` answer) matches its library.

Run: ``python -m kaolin_tpu_torch.native.build``;
:mod:`kaolin_tpu_torch.native` also builds at first use, never at import.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "kaolin_native.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_ROOT = Path(__file__).resolve().parents[2]
_LIB_NAME = "libkaolin_native.so"


def compiler_version(cxx="g++"):
    """The first line of ``g++ --version``; raises RuntimeError without
    g++."""
    try:
        out = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"{cxx} --version failed: {e}") from e
    return out.stdout.splitlines()[0] if out.stdout else ""


def library_path(cxx="g++"):
    """Where the library for this source, these flags and this compiler
    lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(compiler_version(cxx).encode())
    h.update(SOURCE.read_bytes())
    return _ROOT / "build" / "kaolin_tpu_torch" / "native" / \
        h.hexdigest()[:16] / _LIB_NAME


def command(out, cxx="g++"):
    """The g++ command that writes the library to ``out``."""
    return [cxx, *FLAGS, str(SOURCE), "-o", str(out)]


def build(verbose=False, cxx="g++"):
    """Compile the library unless it is built; return its path. A failed
    compile raises RuntimeError with g++'s stderr and leaves nothing."""
    so = library_path(cxx)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    cmd = command(tmp, cxx)
    if verbose:
        print(" ".join(cmd), flush=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
    return so


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
