"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Counterpart of ``deepspeed_tpu/ops/op_builder/`` (which builds the host
C++ ops).  Each ``deepspeed_tpu_torch/csrc/<name>.cu`` compiles on first
use into its own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <name>.cu

under ``<repo>/.torch_build/`` (git-ignored), keyed by a hash of the
sources and the flags, so an unchanged source is not rebuilt within a
checkout.  :func:`build_all` starts one ``nvcc`` per source at once.
A missing ``nvcc`` or a failed build raises; nothing falls back.

The libraries are built for ``sm_90a`` (Hopper), where ``wgmma`` and
``setmaxnreg`` exist; plain ``sm_90`` refuses them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}          # name -> ctypes.CDLL (a library is loaded once per process)
build_log = {}        # name -> {"seconds": float, "ptxas": str, "cached": bool}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built on this machine")
    return found


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start ``nvcc`` for one source; returns (process, tmp, lib, t0) or
    None when the library is already built."""
    lib = _library_path(name)
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib, time.perf_counter()


def _finish(name: str, started):
    proc, tmp, lib, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)      # atomic: concurrent builders never see a partial file
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out, "cached": False}


def build_all(names=None):
    """Build every ``csrc/*.cu`` (or ``names``) not yet built, with one
    ``nvcc`` per source started together; raises on the first failure
    after all have ended."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    nvcc = find_nvcc()
    started = {n: _start(n, nvcc) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            build_log.setdefault(n, {"seconds": 0.0, "ptxas": "", "cached": True})
            continue
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.is_file():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
