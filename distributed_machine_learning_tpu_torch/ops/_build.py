"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded through ``ctypes``.  PyTorch's own extension builder is
not used: it needs ``ninja`` and compiles PyTorch's headers, which takes
minutes per build, while a plain C interface builds in seconds and needs
nothing beyond the CUDA toolkit.

The library lands in ``_build/`` inside the package (listed in
``.gitignore``) under a name keyed on a hash of the source, every header
under ``csrc/`` and the flags, so an edited source or header rebuilds and
an unchanged one loads as it is.
Importing this module compiles nothing; a build or load failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            path = candidate
    if path is None:
        raise KernelBuildError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the port's "
            "CUDA kernels are compiled from csrc/ at first use"
        )
    return path


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    proc.dml_tmp = tmp  # type: ignore[attr-defined]
    return proc


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    stdout, stderr = proc.communicate()
    tmp = proc.dml_tmp  # type: ignore[attr-defined]
    log = BUILD_DIR / f"{name}.log"
    log.write_text(stdout + stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {source_path(name)} (exit {proc.returncode}):\n"
            f"{stderr[-4000:]}"
        )
    os.replace(tmp, library_path(name))


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source not yet built, all nvcc processes at
    once; returns the wall seconds spent (0.0 for ones already built)."""
    names = list(names)
    with _lock:
        t0 = time.monotonic()
        procs = {name: _start_build(name) for name in names}
        for name, proc in procs.items():
            if proc is not None:
                _finish_build(name, proc)
        elapsed = time.monotonic() - t0
    return {
        name: (elapsed if procs[name] is not None else 0.0) for name in names
    }


def build_log(name: str) -> str:
    """nvcc's output from the last build of ``name`` (registers, shared
    memory and spills per kernel, from ``-Xptxas -v``)."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel_wgmma<64,128,2>`` from the mangled name of a
    kernel template instance (its type argument as ``f32``/``bf16``)."""
    m = re.search(r"\d+(flash_[a-z_0-9]+?)I(.*?)EEv", mangled)
    if m is None:
        return mangled
    args = m.group(2)
    kind = ["f32"] if args.startswith("f") else (
        ["bf16"] if args.startswith("13__nv_bfloat16") else [])
    return f"{m.group(1)}<{','.join(kind + re.findall(r'Li(-?\d+)E', args))}>"


def sass_counts(name: str, opcodes=("HGMMA", "HMMA")) -> Optional[dict]:
    """Per kernel function of the built ``csrc/<name>.cu``, how many SASS
    instructions start with each of ``opcodes`` (the tensor-core ones by
    default), from ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run(
        [tool, "-sass", str(library_path(name))], check=True,
        capture_output=True, text=True,
    ).stdout
    counts: Dict[str, Dict[str, int]] = {}
    function = None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            function = _kernel_name(line[len("Function : "):])
            counts[function] = {op: 0 for op in opcodes}
        elif function is not None and "*/" in line:
            # "/*0a60*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], ... ;"
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            for op in opcodes:
                if words and words[0].split(".")[0] == op:
                    counts[function][op] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib
