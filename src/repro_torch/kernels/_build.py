"""Build the port's CUDA C++ kernels at first use and load them with ctypes.

A source ``src/repro_torch/csrc/<name>.cu`` with a plain C interface is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<repo>/build/kernels``, named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. Each
source is one ``nvcc`` call of a few seconds (no PyTorch headers); what
ptxas reports of its kernels (``-Xptxas -v``) is kept beside the library
as ``<name>-<hash>.ptxas``. A
missing ``nvcc`` or a failed build raises with the compiler's output:
there is no fall back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# every CUDA C++ source of the port (``csrc/<name>.cu``); ``build_all``
# compiles them together
SOURCES = ("flash_attention", "quantize", "rmsnorm", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    returns the library's path. ptxas's report goes beside it, written
    before the library, so a library's report always exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    tmp_report = tmp.with_suffix(".ptxas")
    tmp_report.write_text(res.stdout + res.stderr)
    # atomic: a concurrent build writes the same bytes
    os.replace(tmp_report, out.with_suffix(".ptxas"))
    os.replace(tmp, out)
    return out


def ptxas_report(name: str) -> list:
    """:func:`parse_ptxas` of what ptxas printed when :func:`build` compiled
    ``csrc/<name>.cu`` (building it first if need be)."""
    return parse_ptxas(build(name).with_suffix(".ptxas").read_text())


def parse_ptxas(text: str) -> list:
    """For each kernel in ptxas's ``-v`` output, ``{"function": mangled
    name, "registers", "static_smem_bytes", "spill_stores",
    "spill_loads"}`` (dynamic shared memory is set at launch and is not
    among them)."""
    import re

    out = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append({"function": m.group(1), "registers": None,
                        "static_smem_bytes": 0, "spill_stores": 0,
                        "spill_loads": 0})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


# the SASS opcodes ``sass_counts`` reports: tensor-core products, shared
# loads (scalar and ldmatrix), asynchronous copies, and the conversions and
# byte permutes that feed the products
SASS_OPS = ("HMMA", "LDSM", "LDS", "STS", "LDGSTS", "LDG", "STG", "F2F",
            "F2FP", "PRMT", "I2F", "F2I", "MUFU", "SHFL", "BAR")


def cuobjdump() -> str:
    """``cuobjdump`` beside :func:`nvcc`."""
    return str(Path(nvcc()).with_name("cuobjdump"))


def sass_counts(library, prefix: str = "") -> dict:
    """``{mangled kernel: {opcode: count}}`` of the SASS in a built library
    (``cuobjdump -sass``), static counts over each whole kernel, for the
    kernels whose mangled name contains ``prefix``: each opcode of
    :data:`SASS_OPS` by its base name (``LDS`` does not count ``LDSM``),
    every ``HMMA`` form by its full name (``HMMA.16816.F32.BF16``), and
    ``total``."""
    res = subprocess.run([cuobjdump(), "-sass", str(library)],
                         capture_output=True, text=True, check=True)
    return parse_sass(res.stdout, prefix)


def parse_sass(text: str, prefix: str = "") -> dict:
    """:func:`sass_counts` of ``cuobjdump -sass`` output."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {}) if prefix in m.group(1) \
                else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)", line)
        if cur is None or not m:
            continue
        op = m.group(1)
        cur["total"] = cur.get("total", 0) + 1
        if op in SASS_OPS:
            cur[op] = cur.get(op, 0) + 1
        if op == "HMMA":
            full = op + m.group(2)
            cur[full] = cur.get(full, 0) + 1
    return out


def build_all(names=SOURCES) -> dict:
    """Compile several sources (default: all of :data:`SOURCES`) at once,
    one ``nvcc`` process each, all started together; returns ``{name:
    (library path, seconds)}``."""
    def timed(name):
        t0 = time.perf_counter()
        return build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(timed, n) for n in names}
    return {n: f.result() for n, f in futures.items()}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once per process) and load ``csrc/<name>.cu``. ``signatures``
    maps each exported function to its ``argtypes``; every function returns
    a C ``int`` (a ``cudaError_t``, 0 on success)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
