"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exports a plain C launcher. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library and loaded with ``ctypes``
at the first launch. Libraries go into ``_build/`` next to this file,
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. A failed compile raises; nothing
falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    first ``nvcc`` on ``PATH``; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of repro_torch are built from source at first use")
    return found


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` lives once built."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build(sources: list[str]) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together. Returns each compiled source's compiler
    log (the ``-Xptxas=-v`` register/spill report); already-built
    sources are not in it. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for source in sources:
            out = library_path(source)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / source)]
            jobs.append((source, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, errors = {}, []
        for source, out, tmp, proc in jobs:
            logs[source], _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{source}: nvcc exited {proc.returncode}\n"
                              f"{logs[source]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


class CudaKernel:
    """One C launcher of a ``csrc`` library, loaded at its first launch.

    ``launches`` counts successful launches and nothing else, so a run can
    show that its main path went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: list) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None

    def launch(self, *args) -> None:
        """Call the launcher; raise if it reports a CUDA error."""
        if self._fn is None:
            build([self.source])
            self._lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch error {err}")
        self.launches += 1
