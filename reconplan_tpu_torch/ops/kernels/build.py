"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``reconplan_tpu_torch/csrc/*.cu`` source compiles to an object in
its own ``nvcc`` process, all started together, and the objects link into
one shared library with a plain C interface,
``_build/libreconplan_kernels.so``, at first use. The library is rebuilt
when the hash of the sources or of the flags changes; it is never built at
import time. A missing ``nvcc`` or a compile error raises.

``-fmad=false`` keeps every multiply and add separately rounded, so the
kernels equal their plain PyTorch versions bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libreconplan_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points; each returns its cudaGetLastError().
_SIGNATURES = {
    "active_mask_launch": (
        [_P] * 6 + [_I] * 7 + [_F] * 6 + [_P]
    ),
    "brick_integrate_launch": (
        [_P] * 6 + [_I] + [_P] * 4 + [_I] * 5 + [_F] * 9 + [_P]
    ),
    "brick_integrate_fixed_launch": (
        [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I] * 5 + [_F] * 9 + [_P]
    ),
}


def find_nvcc() -> str | None:
    """``nvcc`` on PATH, else under the CUDA home PyTorch found."""
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils import cpp_extension

    home = os.environ.get("CUDA_HOME") or cpp_extension.CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    return None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Compile the sources into ``_build/`` unless an up-to-date library is
    there already. Returns the library's path."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
            "kernels of reconplan_tpu_torch cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        out = Path(tmp) / LIB_NAME
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
             str(src)]
            for src, obj in zip(sources(), objs)
        ])
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(out),
                          *map(str, objs)]])
        if verbose:
            print("\n".join(filter(None, log)))
        os.replace(out, lib)
    stamp.write_text(digest)
    return lib


def _run_all(cmds) -> list[str]:
    """Run the commands as parallel processes and wait for all of them;
    raise with the output of the first that failed, else return each
    one's stderr (ptxas's register report)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{stdout}\n{stderr}"
            )
    return [stderr.strip() for _, stderr in outs]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument and return types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` has the dtype, shape and device a kernel takes
    and is contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
