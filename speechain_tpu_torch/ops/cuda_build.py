"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel source in ``speechain_tpu_torch/csrc/`` exports plain C launch
functions (no PyTorch headers), so ``nvcc`` builds it into a shared library
in seconds. Libraries are built at first use into ``build/kernels/`` at
the root of the checkout, named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only when a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SMEM_LIMIT = 227 * 1024     # dynamic shared memory one block may use (H100)

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
Q = ctypes.c_longlong
F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One kernel source: its C entry points, the TPU kernel each entry
    point replaces, and how often the port launched each.

    ``counts[symbol]`` is a plain integer that the wrapper raises by one at
    each call of that entry point and nowhere else (an entry point such as
    ``ffn_backward`` may launch several CUDA kernels in one call); a run
    calls :meth:`reset_counts` before the path it wants to observe and
    reads the counts after.
    """

    def __init__(self, name: str, source: str,
                 symbols: Dict[str, Sequence], replaces: Dict[str, str]):
        self.name = name
        self.source = CSRC / source
        self.symbols = dict(symbols)
        self.replaces = dict(replaces)
        self.counts = {sym: 0 for sym in self.symbols}
        self.build_log = ""
        self._pending = None
        self._lib = None

    def reset_counts(self) -> None:
        for sym in self.counts:
            self.counts[sym] = 0

    @staticmethod
    def entry_name(symbol: str) -> str:
        """The name of an entry point in reports: the symbol without its
        ``_forward`` suffix (``ffn_forward`` -> ``ffn``)."""
        return symbol[:-len("_forward")] if symbol.endswith(
            "_forward") else symbol

    # -- building ----------------------------------------------------------
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> bool:
        """Start ``nvcc`` unless the library exists; True if started."""
        out = self.lib_path()
        if out.exists():
            return False
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        self._pending = (proc, tmp, out)
        return True

    def _finish_build(self) -> None:
        proc, tmp, out = self._pending
        self._pending = None
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name}:\n{self.build_log}")
        os.replace(tmp, out)      # atomic: a reader never sees half a file

    def build(self) -> None:
        if self._start_build():
            self._finish_build()

    # -- loading -----------------------------------------------------------
    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.lib_path()))
            for sym, argtypes in self.symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, symbol: str, *args) -> None:
        """Call one C entry point; raise if the launch was refused."""
        err = getattr(self.lib, symbol)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: {symbol} failed with cudaError {err}")
        self.counts[symbol] += 1


def build_all(kernels: Iterable[CudaKernel]) -> List[CudaKernel]:
    """Build every kernel that has no library yet, one ``nvcc`` each, all
    started together; returns the kernels in the order given."""
    kernels = list(kernels)
    started = [k for k in kernels if k._start_build()]
    errors = []
    for k in started:
        try:
            k._finish_build()
        except RuntimeError as e:          # report every failed source
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return kernels


def aligned(tensor):
    """``tensor`` contiguous at a 16-byte aligned address, copied only
    where it is not: for kernels that move 16 bytes at a time."""
    tensor = tensor.contiguous()
    return tensor if tensor.data_ptr() % 16 == 0 else tensor.clone()


def stream_ptr(tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def check_cuda_args(name: str, dtypes, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with a dtype from ``dtypes`` (per-argument tuples override)."""
    dev = None
    for arg, t in tensors.items():
        if t is None:
            continue
        allowed = dtypes.get(arg, dtypes.get("*")) if isinstance(
            dtypes, dict) else dtypes
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype not in allowed:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, "
                             f"expected one of {allowed}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
