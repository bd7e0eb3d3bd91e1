"""Build the CUDA kernels at first use and bind them with ctypes.

Counterpart of ``dpdk_dc_sand_tpu/native/build.py``, with one deliberate
difference: a missing ``nvcc`` or a failed build RAISES (with the
compiler's stderr). There is no fallback — a wrapper handed a CUDA tensor
launches its kernel or fails loudly.

Each ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -lineinfo -c -o <build>/<hash>/<source>.o csrc/<source>.cu   # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o <build>/libdcsand_kernels_<hash>.so <build>/<hash>/*.o

The library lands in ``_kernel_build/`` next to this file (ignored by git),
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads in milliseconds. Every pointer and the stream are
passed as ``ctypes.c_void_p``; each launch function returns
``cudaGetLastError()``, which :func:`check` turns into an exception (K1's
and K7's, their stage stops' too, return -1 where no shared-memory plan
fits the shape, which their wrappers raise as ``ValueError``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernel_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
#: Where the CUDA toolkit usually puts nvcc when it is not on PATH.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C signatures of the launch functions in csrc/ (all return cudaError_t).
_SIGNATURES = {
    "fengine_ct_launch": [
        _P, _L, _P,  # x, batch stride (samples), starts [B] int64
        _P, _P, _P, _P, _P, _P,  # window, d1c, d1s, d2 stack, twc, tws
        _P, _P,  # rotc, rots [B, C]
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I, _I, _I, _I,  # batch, n_spectra, n_taps, n1, n2, bf16, quantise
        _P,  # stream
    ],
    "k1_fir_launch": [
        _P, _L, _P, _P,  # x, batch stride (samples), starts [B] int64, window
        _P,  # plane [B, S, fft] bf16
        _I, _I, _I, _I,  # batch, n_spectra, n_taps, fft
        _P,  # stream
    ],
    "k1_dft_launch": [
        _P,  # plane [B, S, N1, N2] bf16
        _P, _P, _P,  # bf16 d1c, d1s [N1, N1], d2 stack [N2, N2]
        _P, _P, _P, _P,  # twc, tws [N1, N2], rotc, rots [B, C]
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I, _I,  # batch, n_spectra, n1, n2, quantise
        _P,  # stream
    ],
    "k1_fir_stop_launch": [
        _P, _L, _P, _P,  # x, batch stride (samples), starts [B] int64, window
        _P, _P, _P,  # plane [B, S, fft] bf16 (fir), outr, outi [B, S, fft/2] int8
        _I, _I, _I, _I, _I,  # batch, n_spectra, n_taps, fft, stop (1 dma, 2 fir)
        _P,  # stream
    ],
    "k1_dft_stop_launch": [
        _P,  # plane [B, S, N1, N2] bf16
        _P, _P, _P, _P, _P,  # bf16 d1c, d1s, d2 stack; twc, tws
        _P, _P,  # outr, outi [B, S, C] int8
        _I, _I, _I, _I, _I,  # batch, n_spectra, n1, n2, stop (3 stagea, 4 stageb)
        _P,  # stream
    ],
    "bstage_fused_launch": [
        _P, _P, _P, _I,  # qr, qi, w, w_is_bf16
        _P,  # out [C/pack, P·S, pack·2B]
        _I, _I, _I, _I,  # n_ants, P·S, n_channels, 2B
        _P,  # stream
    ],
    "corner_turn_launch": [
        _P, _P, _P,  # qr, qi [A·P·S, C], out [C, planes·A·P·S]
        _L, _I, _I,  # rows (A·P·S), n_channels, planes (2: qr and qi; 1: qr)
        _P,  # stream
    ],
    "xcorr_fused_launch": [
        _P, _P, _P, _P,  # qr, qi [A, P, S, C], vre, vim [C, I, I]
        _I, _I, _I,  # n_inputs, n_spectra, n_channels
        _P,  # stream
    ],
    "xcorr_turned_launch": [
        _P, _P, _P,  # xt [C, 2I, S], vre, vim [C, I, I]
        _I, _I, _I,  # n_inputs, n_spectra, n_channels
        _P,  # stream
    ],
    "pfb_fir_launch": [
        _P, _P, _P,  # frames [B, n_frames, F], window [taps, F], out [B, S, F]
        _I, _I, _I, _I,  # batch, n_frames, F, n_taps
        _I, _I,  # frames are f32, vector lane loads
        _P,  # stream
    ],
    "fengine_dit_launch": [
        _P, _P,  # frames [B, n_frames, fft] int8, window [taps, fft]
        _P, _P, _P, _P,  # d1c, d1s [N1, N1], d2c, d2s [N2, N2]
        _P, _P, _P, _P,  # twc, tws [N1, N2], untc, unts [N2, N1]
        _P, _P,  # rotc, rots [B, N]
        _P, _P,  # outr, outi [B, S, N]
        _I, _I, _I, _I, _I, _I,  # batch, n_frames, n_taps, n1, n2, bf16
        _P,  # stream
    ],
    "fengine_dit_stop_launch": [
        _P, _P,  # frames [B, n_frames, fft] int8, window [taps, fft]
        _P, _P, _P, _P, _P, _P,  # d1c, d1s, d2c, d2s, twc, tws
        _P, _P,  # outr, outi [B, S, N] int8
        _I, _I, _I, _I, _I, _I,  # batch, n_frames, n_taps, n1, n2, stop (1 dma .. 6 stageb)
        _P,  # stream
    ],
    "ct_probe_launch": [
        _P, _P, _P,  # qr, qi [A, P, S, C] int8, out
        _I, _I, _I, _I,  # n_ants, n_pols, n_spectra, n_channels
        _I, _I, _I,  # mode (0 copy, 1 i8, 2 i32, 3 i8m, 4 i8m2), c_blk, s_chunk
        _P,  # stream
    ],
    "fir_probe_launch": [
        _P, _P, _P,  # x [(J+15)*N1, N2] bf16, w [16*N1, N2] f32, out [J*N1, N2] f32
        _I, _I, _I, _I, _I,  # n1, n2, passes, tapouter, zero (must be 0)
        _P,  # stream
    ],
    "vector_add_launch": [
        _P, _P, _P, _L,  # x, y, out (f32), n
        _P,  # stream
    ],
}


def find_nvcc() -> str:
    """Path of ``nvcc``, or raise naming what was searched."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, $CUDA_PATH/bin, "
        f"{DEFAULT_NVCC}): the CUDA kernels of dpdk_dc_sand_tpu_torch "
        "are compiled from csrc/ at first use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.blake2b(digest_size=8)
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + [nvcc]).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` (if not cached) and return the library path."""
    nvcc = find_nvcc()
    lib = BUILD_DIR / f"libdcsand_kernels_{_digest(nvcc)}.so"
    if lib.exists():
        return lib
    objdir = BUILD_DIR / f"{lib.stem}.{os.getpid()}.objs"
    objdir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources():
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(objdir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp)]
    link += [str(objdir / f"{src.stem}.o") for src in _sources()]
    try:
        for cmd, proc in jobs:  # the first failure raises; `finally` stops the rest
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}{out}"
                )
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {res.returncode}): {' '.join(link)}\n"
                f"{res.stderr}{res.stdout}"
            )
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(objdir, ignore_errors=True)
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dcsand_error_string.argtypes = [ctypes.c_int]
            lib.dcsand_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        msg = lib.dcsand_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
