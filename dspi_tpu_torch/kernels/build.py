"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries land
in ``dspi_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  ``build_all`` starts one nvcc per missing source, all at once.
``sass`` and ``loop_counts`` read a built kernel's machine code, so that
measurements can count the instructions of its sample loop.

Nothing here runs at import time: the CPU-only hosts that run the tests
have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("pdm", "eq_q28", "xf_q28")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc process per source, run in
    parallel.  Returns {name: {"seconds": wall, "log": ptxas report}};
    raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


# SASS opcodes (before the first '.') that are not per-thread arithmetic
_CONTROL = {"BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
            "BPT", "NOP", "WARPSYNC", "BAR", "YIELD"}
_MEMORY = {"LDG", "STG", "LDC", "LD", "ST", "LDS", "STS", "LDL", "STL"}
# integer ALU instructions that an IMAD form can stand in for (adds, moves,
# plain left shifts and shift-adds: IMAD.IADD, IMAD.MOV, IMAD.SHL), so
# either pipe may issue them; every other ALU instruction (right and funnel
# shifts, logic, compares, selects, min/max) has only the ALU
_EITHER_BASE = {"IADD3", "VIADD", "MOV"}
_EITHER_OP = {"LEA", "SHF.L.U32"}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass(name: str) -> str:
    """The SASS of ``csrc/<name>.cu``'s library (cuobjdump beside nvcc)."""
    load(name)
    cuobjdump = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def loop_counts(sass_text: str, kernel: str) -> dict:
    """Opcode counts of the sample loop of the kernel whose mangled name
    contains ``kernel``: its longest innermost loop (a backward branch
    whose body holds no loop with another head; the cascade kernel walks
    packets in an outer loop around its sample loop).  ``hist`` by
    opcode, ``imad`` the integer multiply-adds (IMAD*, which issue to the
    FMA pipe), ``alu`` the rest of the per-thread arithmetic (the integer
    ALU; not control, memory, uniform or special), ``alu_only`` those of
    them that no IMAD form can stand in for, ``ldg``/``stg`` the global
    loads and stores, ``instructions`` all of them."""
    code = sass_text[sass_text.index(kernel):]
    if "Function :" in code:
        code = code[:code.index("Function :")]
    ins = [(int(a, 16), op, args) for a, op, args in _SASS_LINE.findall(code)]
    loops = [(addr, int(m.group(1), 16)) for addr, op, args in ins
             if op.startswith("BRA")
             and (m := re.search(r"0x([0-9a-f]+)", args))
             and int(m.group(1), 16) < addr]
    inner = [(end, head) for end, head in loops
             if not any(head < h and e <= end for e, h in loops)]
    end, head = max(inner, key=lambda lp: lp[0] - lp[1])
    hist: dict[str, int] = {}
    for addr, op, _ in ins:
        if head <= addr <= end:
            hist[op] = hist.get(op, 0) + 1
    base = {op: op.split(".")[0] for op in hist}
    arith = sum(n for op, n in hist.items()
                if base[op] not in _CONTROL | _MEMORY
                and not base[op].startswith(("U", "S2")))
    imad = sum(n for op, n in hist.items() if base[op] == "IMAD")
    either = sum(n for op, n in hist.items()
                 if base[op] in _EITHER_BASE or op in _EITHER_OP)
    return {"hist": hist, "imad": imad, "alu": arith - imad,
            "alu_only": arith - imad - either,
            "ldg": sum(n for op, n in hist.items() if base[op] == "LDG"),
            "stg": sum(n for op, n in hist.items() if base[op] == "STG"),
            "instructions": sum(hist.values()), "head": head, "end": end}
