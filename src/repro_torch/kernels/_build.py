"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` is compiled for Hopper (``sm_90a``)
into one shared library with a plain C interface, under ``build/`` at the
repository root, keyed by a hash of the sources and flags; a library
already built for the same hash is reused. One ``nvcc`` per source runs
in parallel, then one link. Nothing here runs at import: the CPU tests
import every module on machines without ``nvcc``.

Each C entry point takes device pointers and the stream as ``void*``
(``ctypes.c_void_p``) and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the link adds no library: the TMA kernels fetch libcuda's tensor-map
# encoder through the CUDA runtime (csrc/hopper.cuh), so there is no -lcuda
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# element-type codes of csrc/common.cuh's `DType`
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# C signatures, mirrored from the `extern "C"` declarations in csrc/
SIGNATURES = {
    "repro_flash_attention_fwd": [
        _P, _P, _P, _P, _P,              # q, k, v, o, lse
        _I, _I, _I, _I, _I, _I, _I,      # dtype, B, Sq, Skv, H, KVH, hd
        _L, _L, _L, _L, _L, _L,          # q strides (b, s, h), k strides
        _L, _L, _L, _L, _L, _L,          # v strides, o strides
        _I, _I, _I, _F, _P,              # causal, window, q_offset, sm_scale, stream
    ],
    "repro_flash_attention_bwd_dkdv": [
        _P, _P, _P, _P, _P, _P, _P, _P,  # q, k, v, do, lse, delta, dk, dv
        _I, _I, _I, _I, _I, _I, _I,      # dtype, B, Sq, Skv, H, KVH, hd
        _P,                              # 21 strides (b, s, h) of q, k, v, do, dq, dk, dv
        _I, _I, _I, _F, _P,              # causal, window, q_offset, sm_scale, stream
    ],
    "repro_flash_attention_bwd_dq": [
        _P, _P, _P, _P, _P, _P, _P,      # q, k, v, do, lse, delta, dq
        _I, _I, _I, _I, _I, _I, _I,      # dtype, B, Sq, Skv, H, KVH, hd
        _P,                              # 21 strides, as for dkdv
        _I, _I, _I, _F, _P,              # causal, window, q_offset, sm_scale, stream
    ],
    "repro_paged_attention": [
        _P, _P, _P, _P, _P, _P,          # q, k_pages, v_pages, block_table, seq_lens, out
        _I, _I, _I, _I, _I, _I, _I, _I,  # dtype, B, H, KVH, hd, P, page_size, max_blocks
        _F, _P,                          # sm_scale, stream
    ],
    "repro_ssm_scan": [
        _P, _P, _P, _P, _P, _P, _P,      # u, dt, B_, C_, A, D, h0 (NULL = zeros)
        _P, _P,                          # y, h_final
        _I, _I, _I, _I, _I, _P,          # dtype, B, S, inner, N, stream
    ],
    "repro_mlstm": [
        _P, _P, _P, _P, _P, _P, _P,      # q, k, v, gates, C0, n0, m0 (NULL = zeros)
        _P, _P, _P, _P,                  # h, C, n, m
        _I, _I, _I, _I, _I,              # dtype, B, S, H, hd
        _L, _L, _L, _L, _L, _L,          # q strides (b, s, h), k strides
        _L, _L, _L, _L, _L, _L,          # v strides, h strides
        _L, _L, _P,                      # gate strides (b, s), stream
    ],
}

_lib = None
last_build: dict = {}   # what the last build did: seconds, path, ptxas log


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of every compile and link flag and every source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(b"\0" + " ".join(LINK_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the .so."""
    out = BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"
    if out.is_file():
        last_build.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"repro_torch: nvcc failed for {failed}:\n{log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp_so), *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"repro_torch: link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)  # atomic: a reader never sees half a library
    (BUILD_DIR / (out.stem + ".log")).write_text(log)
    last_build.update(seconds=time.perf_counter() - t0, path=str(out), log=log)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, declare every entry point's C types."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = load().repro_error_string(err).decode()
        raise RuntimeError(f"repro_torch: {what} launch failed: cuda error {err} ({msg})")
