"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source is never served from a stale library). Nothing is compiled
when this module is imported: the first call that needs a kernel builds
it.

There is no fallback: without ``nvcc`` (or without a card) a kernel cannot
be built, and the caller gets an error saying so.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# sm_90a (not sm_90): Hopper's full target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false: round after every multiply and add, as the plain PyTorch
# versions do, for the kernels held to them bit for bit (see the sources).
# The attention and scan kernels sum in an order of their own anyway and
# keep nvcc's fused multiply-adds.
NO_FMA = ("consensus_round", "consensus_update")
# No source links -lcuda: flash_attention_tc.cu and rwkv6_scan.cu build TMA
# tensor maps with libcuda's cuTensorMapEncodeTiled, which they look up at
# run time through the CUDA runtime's entry-point query (libcuda is already
# loaded by the runtime and PyTorch), so the libraries need no libcuda stub
# to link against and load in any process that has a card.

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRY_POINTS: dict[str, ctypes._CFuncPtr] = {}


def flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (("-fmad=false",) if name in NO_FMA else ())


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels under src/repro_torch/kernels/csrc "
        "are compiled at first use and need the CUDA toolkit (nvcc on PATH "
        "or under /usr/local/cuda)")


def library_path(name: str) -> Path:
    # the hash covers the headers too (every source may include them)
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns {"path", "seconds", "log"}, where ``log`` is nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel); a
    library that was already built reports 0 seconds and no log.
    """
    return build_all([name])[name]


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one nvcc process per source, all started together; returns
    {name: build()'s record}. Raises after all have ended if any failed."""
    done, running = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            done[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile into a file of this process, then rename: a reader never
        # sees a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *flags(name), "-o", str(tmp),
                                 str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in running.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode} on {name}.cu\n{log}")
            continue
        os.replace(tmp, path)
        done[name] = {"path": str(path), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name)["path"])
    return lib


def entry_point(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``<name>_launch`` of ``csrc/<name>.cu`` (which returns
    a cudaError_t as an int), built and loaded at first use."""
    fn = _ENTRY_POINTS.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRY_POINTS[name] = fn
    return fn


# SASS opcode families: tensor-core products (wgmma, mma.sync), asynchronous
# copies (TMA, cp.async) and the mbarrier operations that complete them
SASS_FAMILIES = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "SYNCS")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
_TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def short_kernel_name(mangled: str) -> str:
    """'_ZN<ns>18rwkv6_scan_kernelI13__nv_bfloat16Li64ELi32EEEv...' ->
    'rwkv6_scan_kernel<bf16,64,32>' (the kernel's own name and template
    arguments, for printing)."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if not mangled.startswith("I", i):
        return name
    args = re.findall(r"Li(\d+)E|(13__nv_bfloat16|f)(?=L|E)", mangled[i + 1:])
    parts = [_TYPES[t] if t else n for n, t in args]
    return f"{name}<{','.join(parts)}>"


def sass_counts(text: str) -> dict:
    """Per kernel of ``cuobjdump -sass`` output, the count of instructions
    in each of SASS_FAMILIES (opcode prefixes): {short name: {family: n}}."""
    out = {}
    starts = [(m.start(), m.group(1)) for m in _FUNCTION.finditer(text)]
    for n, (pos, name) in enumerate(starts):
        end = starts[n + 1][0] if n + 1 < len(starts) else len(text)
        counts = dict.fromkeys(SASS_FAMILIES, 0)
        for op in _INSTRUCTION.findall(text[pos:end]):
            for fam in SASS_FAMILIES:
                if op.startswith(fam):
                    counts[fam] += 1
        out[short_kernel_name(name)] = counts
    return out


def sass(name: str) -> str:
    """``cuobjdump -sass`` of kernel ``name``'s built library (cuobjdump
    from the toolkit that holds nvcc)."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", build(name)["path"]],
                          capture_output=True, text=True, check=True).stdout
