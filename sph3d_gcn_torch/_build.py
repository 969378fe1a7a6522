"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into one
shared library with a plain ``extern "C"`` interface, loaded with
``ctypes`` (no PyTorch headers: the build takes seconds, not minutes).
The library goes into ``.kernel_build/<hash of sources and flags>/``
beside the package, at first use; an unchanged checkout reuses it.
Nothing is built when the package is imported, and nothing is built for
CPU tensors.

Each launcher returns the ``cudaError_t`` of its launch; :class:`Kernel`
raises on anything but 0 and counts successful launches, so a run can
show that its main path really went through the kernels. Inside
:class:`record_calls` every dispatching wrapper also records the operands
it hands to the kernel or its plain version, so that a run can replay
exactly its main path's calls through both and compare them; the
masked-mean unpool (plain PyTorch, no kernel) records its operands as
``mean_interpolate`` (its backward as ``mean_interpolate_bwd``) so that a
run can time it beside the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / ".kernel_build"
LIB_NAME = "libsph3d_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_LIB: ctypes.CDLL | None = None
_RECORD: list | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the sph3d_gcn_torch CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def build() -> tuple[Path, float]:
    """Compile ``csrc/*.cu`` if needed, one ``nvcc`` process per source
    started together, then link. Returns (library path, seconds spent
    compiling and linking, 0.0 when the library was already built). The
    compiler's ``-Xptxas -v`` report is kept as ``ptxas.log`` beside it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    pid = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f".{src.stem}.{pid}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:          # wait for every process
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if not failed:
        tmp = out_dir / f".{LIB_NAME}.{pid}.tmp"
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp)]
        cmd += [str(obj) for _, obj, _ in jobs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        logs.append(res.stdout)
        if res.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({res.returncode}):\n"
                          f"{res.stdout}")
    seconds = time.perf_counter() - t0
    (out_dir / "ptxas.log").write_text("".join(logs))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    return lib, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.sph3d_error_string.argtypes = [ctypes.c_int]
        lib.sph3d_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class Kernel:
    """One C launcher of the library, with its count of device kernel
    launches (``per_call`` of them each call), kept on ``counter``: itself,
    or the first launcher registered under the same kernel name."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 per_call: int = 1, counter: Kernel | None = None) -> None:
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.per_call = per_call   # device kernels one call launches
        self.launches = 0
        self.counter = counter or self
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().sph3d_error_string(err).decode()
            raise RuntimeError(
                f"kernel {self.name} ({self.symbol}) failed to launch: "
                f"CUDA error {err}: {msg}"
            )
        self.counter.launches += self.per_call


KERNELS: dict[str, Kernel] = {}


def register(name: str, symbol: str, argtypes: list,
             per_call: int = 1) -> Kernel:
    """A launcher of kernel ``name``; a second launcher of the same kernel
    (another C entry) adds its launches to the first's count."""
    k = Kernel(name, symbol, argtypes, per_call, KERNELS.get(name))
    KERNELS.setdefault(name, k)
    return k


def kernel_launches() -> dict[str, int]:
    """Launch count of every registered kernel, by name."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_kernel_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


class record_calls:
    """Context manager: while it is open, :func:`record` appends each
    wrapped call as ``(kernel name, args, kwargs)`` to the list that
    ``with record_calls() as calls`` binds, in call order."""

    def __enter__(self) -> list:
        global _RECORD
        _RECORD = []
        return _RECORD

    def __exit__(self, *exc) -> None:
        global _RECORD
        _RECORD = None


def record(name: str, *args, **kwargs) -> None:
    """Record one call's operands (as the kernel and its plain version
    both take them) when a :class:`record_calls` block is open."""
    if _RECORD is not None:
        _RECORD.append((name, args, kwargs))


# dynamic shared memory a block may use on Hopper (227 KB), less a margin
# for the kernels' static shared memory
MAX_DYNAMIC_SMEM = 227 * 1024 - 1024

# ctypes argument shorthands for the launchers' signatures
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as its raw handle (a
    ``torch.cuda.Stream`` object costs several microseconds a launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def use_kernel(t: torch.Tensor, use_kernels: bool | None) -> bool:
    """Dispatch rule shared by every kernel wrapper.

    ``None`` (the default): the kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``True``: the kernel, raising unless ``t``
    is on a CUDA device. ``False``: the plain version, on any device (for
    comparing the two; never chosen automatically)."""
    if use_kernels is False:
        return False
    if t.device.type == "cuda":
        return True
    if use_kernels:
        raise ValueError(
            f"a CUDA kernel was requested for a tensor on {t.device}; the "
            "kernels run only on CUDA devices"
        )
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """Validate a kernel operand: CUDA, dtype, rank, contiguous."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name} is on {t.device}, but kernels launch on the current "
            f"device cuda:{torch.cuda.current_device()}"
        )
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
