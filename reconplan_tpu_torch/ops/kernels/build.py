"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``reconplan_tpu_torch/csrc/*.cu`` source compiles to an object in
its own ``nvcc`` process, all started together, and the objects link into
one shared library with a plain C interface,
``_build/libreconplan_kernels.so``, at first use. The library is rebuilt
when the hash of the sources or of the flags changes; it is never built at
import time. A missing ``nvcc`` or a compile error raises. Each wrapper
under ``ops/kernels/`` types its own entry point where it calls it
(:func:`entry`): this module knows no kernel by name.

``-fmad=false`` keeps every multiply and add separately rounded, so the
kernels equal their plain PyTorch versions bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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

# the argument types of the entry points' C signatures (:func:`entry`)
PTR, INT, FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


@contextlib.contextmanager
def build_lock():
    """Hold an exclusive lock on ``_build/.lock`` while checking and
    building: test workers and processes that start together then build
    a library once, and none loads a half-written one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def up_to_date(lib: Path, digest: str) -> bool:
    """True when ``lib`` exists and its stamp holds ``digest``."""
    stamp = lib.with_name(lib.name + ".sha256")
    return lib.is_file() and stamp.is_file() and stamp.read_text() == digest


def build(verbose: bool = False) -> Path:
    """Compile the sources into ``_build/`` unless an up-to-date library is
    there already. Returns the library's path."""
    lib = BUILD_DIR / LIB_NAME
    digest = source_hash()
    if up_to_date(lib, digest):
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
            "kernels of reconplan_tpu_torch cannot be built"
        )
    with build_lock():
        # another process may have built it while this one waited
        if not up_to_date(lib, digest):
            _compile(nvcc, lib, digest, verbose)
    return lib


def _compile(nvcc, lib, digest, verbose):
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
    lib.with_name(lib.name + ".sha256").write_text(digest)


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
    """``_ZN12_GLOBAL__N_122brick_integrate_kernelILb0ELi4EEEv...`` ->
    ``brick_integrate_kernel<0,4>``: the last name of the mangled (nested)
    name, read by its length prefixes, and its integer and bool template
    arguments. The anonymous namespace's name may hold a hash whose digits
    look like a length prefix, so the names are read in turn from the
    start. Anything else comes back as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = (3 if mangled.startswith("_ZN") else 2), None
    while length := re.match(r"\d+", mangled[i:]):
        start = i + length.end()
        i = start + int(length.group())
        name = mangled[start:i]
    if name is None or not name.endswith("_kernel"):
        return mangled
    targs = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[i:])
    args = re.findall(r"(\d+)E", targs.group(1)) if targs else []
    return name + (f"<{','.join(args)}>" if args else "")


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
    """Build if needed and load once per process."""
    return ctypes.CDLL(str(build()))


@functools.cache
def entry(name, argtypes):
    """The library's entry point ``name``, typed once: ``argtypes``, a
    tuple of :data:`PTR`, :data:`INT` and :data:`FLT`, and an int result,
    its ``cudaGetLastError()``."""
    fn = getattr(load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def takes_plain(name, device):
    """True on the CPU, where a wrapper takes its kernel's plain version;
    False on a CUDA device, where it launches the kernel; raise on any
    other device."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return False


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
