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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libreconplan_kernels.so"
PTXAS_LOG = "ptxas.log"
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
        [_P] * 6 + [_I] * 3 + [_P] * 4 + [_I] * 5 + [_F] * 9 + [_P]
    ),
    "brick_integrate_occupancy": [_I, _P, _P],
    "brick_integrate_fixed_launch": (
        [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I] * 5 + [_F] * 9 + [_P]
    ),
    "brick_integrate_fixed_occupancy": [_P, _P],
    "brick_ablate_launch": (
        [_I] + [_P] * 5 + [_I] * 3 + [_P] * 3 + [_I] * 5 + [_F] * 9 + [_P]
    ),
    "brick_ablate_occupancy": [_I, _P, _P],
    "gather_probe_launch": [_I] + [_P] * 2 + [_I] * 6 + [_P],
    "gather_probe_occupancy": [_I, _P, _P],
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
    (BUILD_DIR / PTXAS_LOG).write_text("\n".join(log))
    stamp.write_text(digest)
    return lib


def resource_usage() -> dict:
    """Each kernel's registers, static shared memory and spill bytes, as
    ptxas reported them at the last build (``-Xptxas -v``), keyed by the
    kernel's name with its template arguments, e.g.
    ``brick_integrate_kernel<0,4>``."""
    usage, name = {}, None
    for line in (BUILD_DIR / PTXAS_LOG).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return usage


def sass_counts(names=("brick_integrate_kernel", "active_mask_kernel"),
                opcodes=("MUFU", "FCHK", "BSSY")):
    """Each built kernel's SASS instructions, from ``cuobjdump -sass`` of
    the library: {name: {"instructions": n, "MUFU": n, "FCHK": n,
    "BSSY": n}} (a count for each of ``opcodes``) for the kernels whose
    name starts with one of ``names``, or None where the toolkit has no
    ``cuobjdump``. Static counts: every instruction of the function once,
    cold paths included."""
    nvcc = find_nvcc()
    tool = Path(nvcc).with_name("cuobjdump") if nvcc else None
    if tool is None or not tool.is_file():
        return None
    out = subprocess.run([str(tool), "-sass", str(BUILD_DIR / LIB_NAME)],
                         capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name = _kernel_name(block.split("\n", 1)[0].strip())
        if not name.startswith(names):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         block)
        counts[name] = {"instructions": len(ops),
                        **{op: ops.count(op) for op in opcodes}}
    return counts


def _kernel_name(mangled: str) -> str:
    """``..._4cd9310922brick_integrate_kernelILb0ELi4EEEv...`` ->
    ``brick_integrate_kernel<0,4>``: the kernel's name and its integer
    and bool template arguments. A length prefix may follow other digits
    (``...0922brick...``), so each tail of a digit run is tried."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            end = m.end() + int(m.group()[i:])
            ident = mangled[m.end():end]
            if ident.endswith("_kernel"):
                targs = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[end:])
                args = re.findall(r"(\d+)E", targs.group(1)) if targs else []
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


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
