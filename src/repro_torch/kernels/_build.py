"""Builds the port's CUDA sources (``src/repro_torch/csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` alone into a shared library with plain C
entry points, loaded with ``ctypes``: a build that includes PyTorch's headers
takes minutes, this one seconds. Libraries land in ``build/repro_torch/`` at
the repository root (ignored by git), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.

A build happens once per process under a ``threading.Lock`` (threaded
federation clients can reach their first aggregation at the same moment) and
once per build directory under a file lock (several processes may share one
checkout).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg).
# No --use_fast_math: sqrt and division stay IEEE-rounded. -Xptxas=-v reports
# each kernel's registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source name -> nvcc's stderr of this process's build


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` (or the toolkit
    PyTorch itself located). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        f"kernels are compiled from {SRC_DIR} at first use")


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _library_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu*")):  # headers (.cuh) included
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr((NVCC_FLAGS, nvcc)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Returns name -> path."""
    names = sources() if names is None else list(names)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n, nvcc) for n in names}
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            procs = {}
            for name, out in paths.items():
                if out.exists():
                    continue
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
                procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True), tmp)
            failed = []
            for name, (proc, tmp) in procs.items():
                out_text, err_text = proc.communicate()
                build_logs[name] = out_text + err_text
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (exit {proc.returncode}):\n{err_text}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, paths[name])
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return paths


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it first if needed),
    with ``signatures`` (function -> (restype, argtypes)) declared on it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error (a refused
    launch never runs, and a later synchronise would not say so)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
