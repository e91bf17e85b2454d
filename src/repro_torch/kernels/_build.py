"""Build the CUDA sources of ``kernels/*/csrc`` and load them with ctypes.

Each ``.cu`` file is a standalone shared library with a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds). It is compiled for
``sm_90a`` on first use into ``build/repro_torch/`` at the root of the
checkout, under a name keyed by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers raise when it is not 0 (a refused launch never runs, and a later
synchronise would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

# name -> source; one shared library each
SOURCES: Dict[str, Path] = {
    "pow_race": _KERNELS / "pow_hash" / "csrc" / "pow_race.cu",
    "fedavg": _KERNELS / "fedavg" / "csrc" / "fedavg.cu",
    "flash_attention": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "flash_attention_bwd": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention_bwd.cu",
    "ssm_scan": _KERNELS / "ssm_scan" / "csrc" / "ssm_scan.cu",
    "ssm_scan_bwd": _KERNELS / "ssm_scan" / "csrc" / "ssm_scan_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# (kernel, device index, stream handle) -> that kernel's ticket on that
# stream: one int32, zeroed when made, reset to 0 by every launch that
# takes it (launches that share a ticket must not overlap)
_TICKETS: Dict[Tuple[str, int, int], object] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _keyed_path(name: str, src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def library_path(name: str) -> Path:
    return _keyed_path(name, SOURCES[name])


def _nvcc(src: Path, out: Path) -> Tuple[Path, subprocess.Popen]:
    """Start ``nvcc`` on ``src`` into a temporary file beside ``out``;
    returns (that file, the process)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once; return each one's compiler output (``-Xptxas -v``
    register and spill report). Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    procs: List = []
    for name in names:
        out = library_path(name)
        if not out.exists():
            procs.append((name, out, *_nvcc(SOURCES[name], out)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``name`` (built first if needed). Every
    library exports ``repro_cuda_error_string(int)``."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def load_file(src: Path, name: str) -> ctypes.CDLL:
    """A library built from any ``.cu`` file ``src`` with the port's
    flags (a test kernel, another tree's source), cached in BUILD_DIR
    under ``name`` and a hash of source and flags like the port's own."""
    out = _keyed_path(name, Path(src))
    if not out.exists():
        tmp, proc = _nvcc(Path(src), out)
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {src} failed (nvcc exit "
                               f"{proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ticket(dev, name: str):
    """(``name``'s last-block ticket on the current stream of CUDA device
    ``dev``, that stream's handle)."""
    import torch

    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (name, dev.index, stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        _TICKETS[key] = ticket
    return ticket, stream
