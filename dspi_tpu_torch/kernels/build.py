"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  A source may
also be built several times with different ``-D`` defines, one library
each (the float cascade kernel, ``eq_f32.cu``, builds one a band-kinds
signature: ``eq_f32_cuda.py``).  Libraries land in
``dspi_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the flags and the defines, so an edited source is rebuilt and a stale
library is never loaded.  ``build_all`` starts one nvcc per missing
library, all at once.  ``sass``, ``loop_counts``, ``per_sample`` and
``opcodes_per_sample`` read a built kernel's machine code, so that
measurements can count the instructions of its sample loop;
``registers`` reads each kernel's registers from the build's ptxas report.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the sources built as they are; eq_f32.cu needs a signature's defines
SOURCES = ("pdm", "eq_q28", "xf_q28", "xf_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[tuple[str, Path, tuple], ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def lib_path(name: str, src_dir: Path = SRC_DIR, defines=()) -> Path:
    """Where ``<src_dir>/<name>.cu``'s library built with ``defines`` goes:
    named by a hash of the source, the flags and the defines, so sources of
    the same name from two directories (another revision's, for a
    comparison) do not collide, nor do two builds of one source."""
    src = (Path(src_dir) / f"{name}.cu").read_bytes()
    flags = " ".join((*NVCC_FLAGS, *defines)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def lib_key(name: str, src_dir: Path = SRC_DIR, defines=()) -> str:
    """A library's key in ``build_all``'s report: the source's name, or
    "<dir>/<name>" outside csrc/, then its defines."""
    key = name if Path(src_dir) == SRC_DIR else f"{src_dir}/{name}"
    return " ".join((key, *defines))


def build_all(names=SOURCES, src_dirs=(SRC_DIR,), variants=()) -> dict:
    """Compile every missing library of ``names`` in each of ``src_dirs``,
    and of ``variants`` ((name, src_dir, defines) each), one nvcc process
    per library, all run in parallel.  Returns {lib_key: {"seconds": the
    process's wall time, "log": ptxas report}}; raises with nvcc's output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    outs = set()
    jobs = [(name, Path(d), ()) for d in src_dirs for name in names]
    jobs += [(name, Path(d), tuple(defs)) for name, d, defs in variants]
    for name, src_dir, defines in jobs:
        out = lib_path(name, src_dir, defines)
        if out.exists() or out in outs:         # built, or the same source
            continue
        outs.add(out)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(src_dir / f"{name}.cu")]
        procs[lib_key(name, src_dir, defines)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), tmp, out)

    def wait(key):
        # each process's own wall time: all were started at t0
        log, _ = procs[key][0].communicate()
        return key, log, time.perf_counter() - t0

    report = {}
    failed = []
    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        for key, log, seconds in pool.map(wait, list(procs)):
            proc, tmp, out = procs[key]
            if proc.returncode != 0:
                failed.append(f"{key}:\n{log}")
                continue
            os.replace(tmp, out)
            report[key] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return report


def load(name: str, src_dir: Path = SRC_DIR, defines=()) -> ctypes.CDLL:
    """The loaded library for ``<src_dir>/<name>.cu`` built with
    ``defines``, built at first use."""
    key = (name, Path(src_dir), tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        # imported here: this module imports nothing of torch
        from ..runtime.telemetry import span

        with span("dspi.kernel_load"):
            path = lib_path(name, src_dir, defines)
            if not path.exists():
                build_all((), (), [(name, src_dir, defines)])
            lib = ctypes.CDLL(str(path))
        _LIBS[key] = lib
    return lib


def registers(log: str) -> dict:
    """{mangled kernel name: registers a thread} from a ptxas -v report."""
    regs = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


# SASS opcodes (before the first '.') that are not per-thread arithmetic
_CONTROL = {"BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
            "BPT", "NOP", "WARPSYNC", "BAR", "YIELD", "DEPBAR"}
# LDGSTS is cp.async (a global -> shared copy), LDGDEPBAR its commit
_MEMORY = {"LDG", "STG", "LDC", "LD", "ST", "LDS", "STS", "LDL", "STL",
           "LDGSTS", "LDGDEPBAR"}
# integer ALU instructions that an IMAD form can stand in for (adds, moves,
# plain left shifts and shift-adds: IMAD.IADD, IMAD.MOV, IMAD.SHL), so
# either pipe may issue them; every other ALU instruction (right and funnel
# shifts, logic, compares, selects, min/max) has only the ALU
_EITHER_BASE = {"IADD3", "VIADD", "MOV"}
_EITHER_OP = {"LEA", "SHF.L.U32"}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
# an instruction's two encoding words as cuobjdump prints them; the stall
# count ptxas scheduled after it (the clocks before the warp's next issue)
# is bits 41-44 of the second (bits 105-108 of the 128-bit instruction)
_SASS_WORDS = re.compile(r"/\*([0-9a-f]{4,})\*/[^;]*;\s*/\*\s*0x([0-9a-f]{16})"
                         r"\s*\*/\s*/\*\s*0x([0-9a-f]{16})\s*\*/")


def sass(name: str, src_dir: Path = SRC_DIR, defines=()) -> str:
    """The SASS of ``<src_dir>/<name>.cu``'s library built with
    ``defines`` (cuobjdump beside nvcc)."""
    load(name, src_dir, defines)
    cuobjdump = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass",
                           str(lib_path(name, src_dir, defines))],
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
    them that no IMAD form can stand in for, ``ldg``/``stg``/``lds``/
    ``ldgsts`` the global loads and stores, shared loads and asynchronous
    global -> shared copies, ``instructions`` all of them, ``stall`` the
    stall counts ptxas scheduled after them summed (the loop's static
    schedule in SM clocks for one warp; None without encodings)."""
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
    stalls = [(int(hi, 16) >> 41) & 0xF for a, _, hi in
              _SASS_WORDS.findall(code) if head <= int(a, 16) <= end]
    base = {op: op.split(".")[0] for op in hist}
    arith = sum(n for op, n in hist.items()
                if base[op] not in _CONTROL | _MEMORY
                and not base[op].startswith(("U", "S2")))
    imad = sum(n for op, n in hist.items() if base[op] == "IMAD")
    either = sum(n for op, n in hist.items()
                 if base[op] in _EITHER_BASE or op in _EITHER_OP)
    return {"hist": hist, "imad": imad, "alu": arith - imad,
            "alu_only": arith - imad - either,
            **{k.lower(): sum(n for op, n in hist.items() if base[op] == k)
               for k in ("LDG", "STG", "LDS", "LDGSTS")},
            "instructions": sum(hist.values()),
            "stall": sum(stalls) if stalls else None, "head": head,
            "end": end}


def opcodes_per_sample(counts: dict, samples: float) -> dict:
    """A loop's instructions by base opcode (FMUL, FADD, BRA, ISETP, LDS,
    ...; ``counts`` from ``loop_counts``), each over the ``samples`` one
    iteration walks."""
    by: dict[str, float] = {}
    for op, n in counts["hist"].items():
        base = op.split(".")[0]
        by[base] = by.get(base, 0) + n / samples
    return by


def per_sample(counts: dict, op: str, per: int) -> dict:
    """ALU-only and all per-thread arithmetic instructions a sample of a
    loop from ``loop_counts``, taking the loop's samples per iteration as
    its count of ``op`` ("ldg", "stg", "lds", ...) over ``per``, that
    instruction's count a sample: a loop that reads its inputs from shared
    memory has no global loads, and an unrolled loop walks several
    samples an iteration."""
    samples = counts[op] / per
    if not samples:
        raise ValueError(f"the sample loop has no {op.upper()}")
    return {"alu_only": counts["alu_only"] / samples,
            "arith": (counts["imad"] + counts["alu"]) / samples,
            "samples_per_iteration": samples}
