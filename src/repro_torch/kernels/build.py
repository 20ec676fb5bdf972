"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them in seconds into one shared library that ``ctypes`` loads; no PyTorch
header is involved.  Each source is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into
``librepro_torch-<hash>.so``.  The library is built at first use into
``build/repro_torch/`` at the root of the checkout, under a name keyed on a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def sources() -> List[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def _run(cmds: List[List[str]]) -> str:
    """Run the commands side by side; raise with the first failure's output.
    Returns their output, in the order given."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Tuple[Path, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns the library's path and the compiler's report (``-Xptxas=-v``:
    registers, shared memory and spills per kernel), which is kept beside
    the library, so a library built earlier returns it too.
    """
    so = library_path()
    report = so.with_suffix(".log")
    if so.exists():
        return so, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    units = {p: BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources() if p.suffix == ".cu"}
    tmp = so.with_name(f"{tag}.tmp.so")
    try:
        log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in units.items()])
        log += _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, units.values())]])
        report.write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent loader sees no half-written file
    finally:
        tmp.unlink(missing_ok=True)
        for o in units.values():
            o.unlink(missing_ok=True)
    return so, log


def sass_instruction_counts(so: Path, kernel: str, opcodes: Tuple[str, ...]) -> dict:
    """{mangled kernel name: {opcode: count}} for every kernel in the
    library whose name holds ``kernel``, read from ``cuobjdump --dump-sass``
    (the toolkit's, beside ``nvcc``)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(so)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        if kernel in name:
            counts[name.strip()] = {op: len(re.findall(rf"\b{op}\b", body)) for op in opcodes}
    return counts


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "repro_segment_aggregate_f32": [_P, _P, ctypes.c_int, _P, _P, _I64, _I64, _I64, _P],
    "repro_segment_aggregate_bf16": [_P, _P, ctypes.c_int, _P, _P, _I64, _I64, _I64, _P],
    "repro_aggregate_f32": [_P, _P, _P, _I64, _I64, _P],
    "repro_aggregate_bf16": [_P, _P, _P, _I64, _I64, _P],
    "repro_flash_attention_f32": [_P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int, _I64, _P],
    "repro_flash_attention_f32_tile": [ctypes.c_int],
    "repro_flash_attention_wgmma_bf16": [_P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int, _I64, _P],
    "repro_topk_gating_f32": [_P, _P, _I64, _I64, _I64, _P],
    "repro_topk_gating_bf16": [_P, _P, _I64, _I64, _I64, _P],
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with every entry's
    argument types declared (a pointer passed without them is cut to 32
    bits)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
