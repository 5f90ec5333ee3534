"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library lands in ``build/kernels/`` beside the package, named by a hash
of the sources and flags, so a changed source builds anew and an unchanged
one loads at once.  The sources compile in parallel, one ``nvcc`` each.

Nothing builds at import: :func:`load` builds on first use, and a failed
build raises.
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
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# the dropout arguments of the block kernels (DropCfg in csrc/drop.cuh):
# on, seed, batch tile, threshold and keep scale for drop_p and ffn_drop_p
_DROP = [_I, _U, _I, _U, _F, _U, _F]
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    # x, out, params[16], B, T, E, H, F, inv_scale, dropout, saved (may be NULL), stream
    "tce_fused_block_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _F, *_DROP, _P, _P], _I),
    # x, g, saved, params[16], dx, dparams[16], workspace, B, T, E, H, F,
    # inv_scale, dropout, stream
    "tce_fused_block_bwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, *_DROP,
                             _P], _I),
    "tce_fused_block_bwd_workspace": ([_I, _I], _L),
    # xw, whh, h_out, c_out (may be NULL), gates_out (may be NULL), T, D, B, H,
    # the launch plan (cluster size, batch tile, threads, shared-memory bytes), stream
    "tce_lstm_scan_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _P], _I),
    # gates, whh, c, g, dxw, T, D, B, H, the launch plan as above, stream
    "tce_lstm_scan_bwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _P], _I),
    # h, dxw, dwhh, workspace, T, D, B, H, stream
    "tce_lstm_dwhh": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "tce_lstm_dwhh_workspace": ([_I, _I, _I, _I], _L),
    # x, w (tap-major), b, scale, bias, out, B, T, C, K, the first five dropout
    # arguments, saved z and saved stats (both may be NULL), stream
    "tce_fused_conv_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, *_DROP[:5], _P, _P, _P],
                           _I),
    # x, w (tap-major), out, B, T, C, K, zero rows before x, stream
    "tce_conv1d_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    # x, g, z, stats, scale, bias, dconv, dw, db, dln, workspace, B, T, C, K,
    # the first five dropout arguments, stream
    "tce_fused_conv_bwd": ([_P] * 11 + [_I, _I, _I, _I, *_DROP[:5], _P], _I),
    "tce_fused_conv_bwd_workspace": ([_I, _I, _I], _L),
    "tce_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the port's "
            "CUDA kernels cannot be built"
        )
    return path


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtce_kernels_{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources (one ``nvcc`` each, all started together) and
    link them; returns the library's path.  ``verbose`` prints what
    ``ptxas -v`` reports: registers, shared memory and spills per kernel."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = sorted(SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed, logs = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"[nvcc {src.name}]\n{log}")
            if verbose or proc.returncode:
                print(logs[-1], flush=True)
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        build_log(out).write_text("".join(logs))
        os.replace(tmp_lib, out)
    if verbose:
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def build_log(lib: Path) -> Path:
    """Where :func:`build` keeps what ``nvcc`` printed for ``lib``."""
    return lib.with_suffix(".log")


def ptxas_usage() -> dict:
    """Per kernel (mangled name), what ``ptxas -v`` reported when the
    library was built: ``registers``, ``spill_stores`` and ``spill_loads``
    (bytes) and ``stack`` (bytes of stack frame)."""
    usage, name = {}, None
    for line in build_log(library_path()).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", line)
        if m:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if rc != 0:
        msg = lib.tce_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
