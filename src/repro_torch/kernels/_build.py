"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` is compiled for Hopper (``sm_90a``)
into one shared library with a plain C interface, under ``build/`` at the
repository root, keyed by a hash of the sources and flags; a library
already built for the same hash is reused. One ``nvcc`` per source runs
in parallel, then one link. Nothing here runs at import: the CPU tests
import every module on machines without ``nvcc``.

Each C entry point takes device pointers and the stream as ``void*``
(``ctypes.c_void_p``) and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0. The wrappers call them through
:func:`launch`, which on the ``meta`` device launches nothing and hands the
call to the dry run's counters instead (``meta_sinks``).
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

_MLSTM = [
    _P, _P, _P, _P, _P, _P, _P,          # q, k, v, gates, C0, n0, m0 (NULL = zeros)
    _P, _P, _P, _P,                      # h, C, n, m
    _I, _I, _I, _I, _I,                  # dtype, B, S, H, hd
    _L, _L, _L, _L, _L, _L,              # q strides (b, s, h), k strides
    _L, _L, _L, _L, _L, _L,              # v strides, h strides
    _L, _L, _P,                          # gate strides (b, s), stream
]

# the chunkwise kernels also take what they keep for the gradient: C, n, m
# at each chunk's start and n.q at each step (NULL = not kept)
_MLSTM_KEEP = _MLSTM[:11] + [_P, _P, _P, _P] + _MLSTM[11:]

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
        _P, _P, _P, _P, _P, _P, _P,      # q, k_pages, v_pages, block_table, seq_lens, out,
                                         # workspace
        _I, _I, _I, _I, _I, _I, _I, _I,  # dtype, B, H, KVH, hd, P, page_size, max_blocks
        _I, _F, _P,                      # segments, sm_scale, stream
    ],
    "repro_paged_attention_int8": [
        _P, _P, _P, _P, _P,              # q, k_codes, v_codes, k_scale, v_scale,
        _P, _P, _P, _P,                  # block_table, seq_lens, out, workspace
        _I, _I, _I, _I, _I, _I, _I, _I,  # dtype, B, H, KVH, hd, P, page_size, max_blocks
        _I, _F, _P,                      # segments, sm_scale, stream
    ],
    "repro_ssm_scan": [
        _P, _P, _P, _P, _P, _P, _P,      # u, dt, B_, C_, A, D, h0 (NULL = zeros)
        _P, _P, _P,                      # y, h_final, h_chunks (NULL = not kept)
        _I, _I, _I, _I, _I, _P,          # dtype, B, S, inner, N, stream
    ],
    "repro_ssm_scan_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P,  # u, dt, B_, C_, A, D, h0, h_chunks
        _P, _P,                          # dy, dh (NULL = zeros)
        _P, _P, _P, _P, _P,              # du, ddt, dB_ and dC_, dA and dD, dh0 (NULL = none)
        _P,                              # the segments' carries (NULL with one segment)
        _P, _P,                          # partials: dB_ and dC_ by block, dA and dD by
                                         # (row, segment)
        _I, _I, _I, _I, _I, _I, _P,      # dtype, B, S, inner, N, steps a segment, stream
    ],
    "repro_mlstm": _MLSTM_KEEP,          # split-TF32 chunkwise kernel
    "repro_mlstm_step": _MLSTM,          # one-pass decode step
    "repro_mlstm_tc": _MLSTM_KEEP[:15] + _MLSTM_KEEP[16:],   # tensor cores, bf16 only: no dtype
    "repro_mlstm_tc_split": _MLSTM_KEEP[:15] + _MLSTM_KEEP[16:],   # the same, carry + output pass
    "repro_mlstm_bwd": [
        _P, _P, _P, _P,                  # 15 inputs, 7 outputs, 8 workspaces (pointer arrays)
        _I, _I, _I, _I, _I, _P,          # dtype, B, S, H, hd, stream
    ],                                   # (the fourth: 17 strides)
    "repro_slstm_fwd": [
        _P, _P, _P, _P, _P, _P,          # wx, r, c0, n0, h0, m0 (NULL = zeros)
        _P, _P, _P, _P, _P,              # hs, the final c, n, h, m
        _P, _P, _P, _P,                  # kept pre, c, n, m (NULL = not kept)
        _P, _I, _I, _I, _P,              # exchange (NULL at S = 1), B, S, d, stream
    ],
    "repro_slstm_bwd": [
        _P, _P, _P, _P, _P, _P,          # r, hs, kept pre, c, n, m
        _P, _P, _P, _P,                  # c0, n0, m0 (NULL = zeros), dhs (NULL = zeros)
        _P, _P, _P, _P,                  # the final state's dc, dn, dh, dm (NULL = zeros)
        _P, _P, _P, _P, _P,              # dpre, the start state's dc, dn, dh, dm (NULL = none)
        _P, _I, _I, _I, _P,              # exchange (NULL at S = 1 without c0), B, S, d, stream
        _P,                              # r^T (4d, d), read by the wide grid only (NULL: unused)
    ],
    "repro_slstm_units": [_I, _I, _I],   # B, d, backward: units a block, 0 where no grid fits
}

_lib = None
last_build: dict = {}   # what the last build did: seconds, path, ptxas log

STREAM = object()       # stands for the current stream among a launch's arguments
# the counters of the dry runs that are on (``launch/op_cost.py``): each is
# called as sink(kernel, **shape) for a call on the meta device
meta_sinks: list = []


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


def launch(entry: str, kernel: str, dev: torch.device, args: tuple, **shape) -> bool:
    """Launch C entry point ``entry`` with ``args`` (``STREAM`` replaced by
    ``dev``'s current stream) and raise on a CUDA error; True: the caller
    counts the launch. On the meta device nothing is built or launched: the
    call of ``kernel`` (a launch counter's name, ``shape`` what its cost
    function in the kernel's ``ops.py`` reads) goes to ``meta_sinks``, and
    False is returned."""
    if dev.type == "meta":
        for sink in meta_sinks:
            sink(kernel, **shape)
        return False
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(load(), entry)(*(stream if a is STREAM else a for a in args))
    check(err, kernel)
    return True


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = load().repro_error_string(err).decode()
        raise RuntimeError(f"repro_torch: {what} launch failed: cuda error {err} ({msg})")
