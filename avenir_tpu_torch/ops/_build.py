"""Build and load the port's CUDA kernels: ``nvcc`` into one shared library
with a plain C interface, bound with ``ctypes``.

At first use every ``csrc/*.cu`` compiles for ``sm_90a`` (one ``nvcc``
process per source, all started together), links into
``_build/<hash>/libavt_kernels.so`` and loads. ``<hash>`` covers the
sources, the headers they share (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one loads the library already
built. ``_build/`` is listed in ``.gitignore``.

No kernel is replaced by anything else: a missing ``nvcc`` or a failed
build raises :class:`BuildError` with the compiler's output. Each build and each load reports its seconds to
``obs/runtime.py`` (the telemetry report's ``compile`` section).

Pointers and the stream travel as ``c_void_p`` and sizes as ``c_int``;
without the declared ``argtypes`` ctypes would pass 32-bit ints and cut
the pointers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

from avenir_tpu_torch.obs import runtime

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libavt_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: K3's division must stay IEEE (-prec-div=true)
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]


class BuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile or link."""


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc") or "")
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels of avenir_tpu_torch need the "
        "CUDA toolkit to build")


def build() -> Path:
    """Compile ``csrc/*.cu`` (unless this exact build exists) and return
    the library's path. The compiler's output lands in ``build.log`` beside
    the library (``-Xptxas -v``: registers, shared memory, spills)."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise BuildError(f"nvcc failed on {', '.join(failed)}:\n"
                         + "\n".join(log))
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", *ARCH_FLAGS, "-o", str(tmp),
                           *objs], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise BuildError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    runtime.record_compile("nvcc_build", time.perf_counter() - t0)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "avt_cfb_counts": ([_P, _P, _P, _I, _I, _I, _I, _P, _I, _P], _I),
    "avt_cfb_sums_int": ([_P, _P, _P, _I, _I, _I, _I, _P, _I, _P], _I),
    "avt_pair_counts_multi": ([_P, ctypes.c_longlong, _P, _I, _P, _I, _I, _I,
                               _I, _I, _P, _I, _P], _I),
    "avt_topk_splits": ([_I, _I, _I, _I], _I),
    "avt_topk_staged": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
                        _I),
    "avt_topk_tpose": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
                       _I),
    "avt_topk_fused": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                        _I, _P], _I),
    "avt_topk_nodot": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
                       _I),
    "avt_topk_sweep": ([_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
                       _I),
    "avt_fold_acc": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                      _P, _P, _I, _P], _I),
    "avt_fold_dotmin": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P], _I),
    "avt_fold_nodot": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                        _I, _P], _I),
    "avt_fold_tpose": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _I, _P], _I),
    "avt_fold_raw": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _I, _P], _I),
    "avt_fold_int8": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P, _I, _P], _I),
    "avt_fold_packed": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                         _I, _P], _I),
    "avt_error_string": ([_I], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once per
    process, with every function's ``argtypes``/``restype`` declared."""
    path = build()
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    runtime.record_compile("library_load", time.perf_counter() - t0)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = load_library().avt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
