"""Build the repo's host C++ ops with ``g++`` and load them with ``ctypes``.

Counterpart of ``deepspeed_tpu/ops/op_builder/builder.py`` (lines
31-208), beside the port's CUDA builder (``cuda.py``), which it does not
touch.  The source is the repo's own ``csrc/adam/ds_cpu_adam.cpp``
(Adam(W), Adagrad dense and row-sparse, the memcpy and bf16 sweeps),
compiled as it is with the JAX builder's flags::

    g++ -O3 -std=c++17 -fPIC -shared -fopenmp -march=native <src> -o <lib>

into the git-ignored ``<repo>/.torch_build/<lib>-<hash>.so`` at first use,
keyed by a hash of the sources, the flags and the host CPU's feature
flags (``-march=native`` builds for them), so the same machine code runs
here and under the JAX package's builder.

:class:`HostLandAddBuilder` builds the port's own
``deepspeed_tpu_torch/csrc/host/land_add.cpp`` (the streamed parameter
tier's one-pass bf16 land-and-accumulate) with the same flags.
:class:`AsyncIOBuilder` builds the repo's ``csrc/aio/ds_aio.cpp`` (the
NVMe tier's kernel AIO over raw ``io_setup`` / ``io_submit``, with
``O_DIRECT`` for aligned requests; JAX ``builder.py:129-158``) the same
way, with ``-O3 -std=c++17 -fPIC -shared -pthread``, and types its C ABI
(``ds_aio.cpp:338-403``); ``ops/aio`` wraps it.

Deliberate differences: one builder for the Adam library (the JAX
package registers ``cpu_adam``, ``cpu_adagrad`` and ``utils`` builders
that all name it); a missing ``g++``, a missing source or a failed build
raises (the JAX package's ``cpu_adam.py:37`` falls back to numpy; here
nothing does).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
CSRC_DIR = REPO / "csrc"
PORT_CSRC_DIR = REPO / "deepspeed_tpu_torch" / "csrc"
BUILD_DIR = REPO / ".torch_build"
CFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", "-march=native"]

_build_lock = threading.Lock()

c_i64 = ctypes.c_int64
c_int = ctypes.c_int
c_f32 = ctypes.c_float
c_void = ctypes.c_void_p
c_str = ctypes.c_char_p
f32p = ctypes.POINTER(ctypes.c_float)
u16p = ctypes.POINTER(ctypes.c_uint16)
i64p = ctypes.POINTER(ctypes.c_int64)


def _cpu_flags():
    """The host CPU's feature flags (``/proc/cpuinfo``), or "" where
    there is none."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


class HostOpBuilder:
    """One library of ``csrc/``, compiled once and loaded via ctypes with
    every entry typed (``_declare``)."""

    NAME = None
    SOURCES = ()                            # relative to csrc/
    CFLAGS = CFLAGS

    def __init__(self):
        self._lib = None

    def sources(self):
        return [CSRC_DIR / s for s in self.SOURCES]

    def cflags(self):
        return list(self.CFLAGS)

    def lib_path(self):
        h = hashlib.sha256()
        for s in self.sources():
            h.update(s.read_bytes())
        h.update(" ".join(self.cflags()).encode())
        if "-march=native" in self.cflags():
            h.update(_cpu_flags().encode())
        return BUILD_DIR / f"{self.NAME}-{h.hexdigest()[:16]}.so"

    def jit_build(self):
        """Compile the sources into the cached library; returns its path.
        Raises when g++ or a source is missing, or the build fails."""
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"{self.NAME}: g++ not found on the PATH; the host op "
                               "cannot be built on this machine")
        missing = [str(s) for s in self.sources() if not s.is_file()]
        if missing:
            raise FileNotFoundError(f"{self.NAME}: missing sources {missing}")
        out = self.lib_path()
        with _build_lock:
            if out.is_file():
                return out
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a private temporary, then an atomic rename: concurrent builders
            # never load a partial file
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [gxx, *self.cflags(), *map(str, self.sources()), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {self.NAME} (exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
        return out

    def load(self):
        """Build if needed and return the ctypes library with typed symbols."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.jit_build()))
            self._declare(lib)
            self._lib = lib
        return self._lib


class CPUAdamBuilder(HostOpBuilder):
    """``csrc/adam/ds_cpu_adam.cpp``: Adam(W), Adagrad, the memcpy and bf16
    sweeps."""

    NAME = "cpu_adam"
    SOURCES = ("adam/ds_cpu_adam.cpp",)

    @staticmethod
    def _declare(lib):
        lib.ds_adam_step.argtypes = [f32p, f32p, f32p, f32p, c_i64, c_i64, c_f32, c_f32,
                                     c_f32, c_f32, c_f32, c_int, c_int, u16p, c_int]
        lib.ds_adam_step.restype = c_int
        lib.ds_adagrad_step.argtypes = [f32p, f32p, f32p, c_i64, c_f32, c_f32, c_f32,
                                        u16p, c_int]
        lib.ds_adagrad_step.restype = c_int
        lib.ds_adagrad_step_sparse.argtypes = [f32p, i64p, f32p, f32p, c_i64, c_i64,
                                               c_f32, c_f32, c_f32, u16p, c_int]
        lib.ds_adagrad_step_sparse.restype = c_int
        lib.ds_memcpy.argtypes = [c_void, c_void, c_i64]
        lib.ds_memcpy.restype = c_int
        lib.ds_fp32_to_bf16.argtypes = [f32p, u16p, c_i64]
        lib.ds_fp32_to_bf16.restype = c_int
        lib.ds_bf16_to_fp32.argtypes = [u16p, f32p, c_i64]
        lib.ds_bf16_to_fp32.restype = c_int


class AsyncIOBuilder(HostOpBuilder):
    """``csrc/aio/ds_aio.cpp``: the ``dsaio_*`` handle (create / destroy,
    sync and async pread / pwrite, wait, the accessors)."""

    NAME = "async_io"
    SOURCES = ("aio/ds_aio.cpp",)
    CFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

    @staticmethod
    def _declare(lib):
        lib.dsaio_create.argtypes = [c_i64, c_int, c_int, c_int, c_int]
        lib.dsaio_create.restype = c_void
        lib.dsaio_destroy.argtypes = [c_void]
        lib.dsaio_destroy.restype = None
        for sym, res in (("dsaio_sync_pread", c_i64), ("dsaio_sync_pwrite", c_i64),
                         ("dsaio_async_pread", c_int), ("dsaio_async_pwrite", c_int)):
            fn = getattr(lib, sym)
            fn.argtypes = [c_void, c_str, c_void, c_i64, c_i64]
            fn.restype = res
        for sym, res in (("dsaio_wait", c_i64), ("dsaio_block_size", c_i64),
                         ("dsaio_queue_depth", c_int), ("dsaio_single_submit", c_int),
                         ("dsaio_overlap_events", c_int), ("dsaio_thread_count", c_int),
                         ("dsaio_pending_count", c_i64)):
            fn = getattr(lib, sym)
            fn.argtypes = [c_void]
            fn.restype = res


class HostLandAddBuilder(HostOpBuilder):
    """The port's own ``deepspeed_tpu_torch/csrc/host/land_add.cpp``: the
    streamed tier's one-pass bf16 land-and-accumulate, with the Adam
    library's flags."""

    NAME = "land_add"
    SOURCES = ("host/land_add.cpp",)

    def sources(self):
        return [PORT_CSRC_DIR / s for s in self.SOURCES]

    @staticmethod
    def _declare(lib):
        lib.ds_bf16_accumulate.argtypes = [u16p, f32p, c_i64]
        lib.ds_bf16_accumulate.restype = c_int


_builder = CPUAdamBuilder()


def load_library():
    """The process's loaded host-op library."""
    return _builder.load()
