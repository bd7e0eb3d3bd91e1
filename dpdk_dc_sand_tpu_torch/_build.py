"""Build the CUDA kernels and the host library at first use and bind them with ctypes.

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
and K7's, their passes' and stage stops' too, return -1 where no
shared-memory plan fits the shape, which their wrappers raise as
``ValueError``).

:func:`build_host` builds the host library the same way: the five
``native/*.cpp`` (the ring, the SPEAD codecs, the RAM scan, the burst-UDP
and AF_XDP engines) in one ``g++`` call, with the JAX package's flags and
``-Wl,-Bsymbolic``, so that the library's own calls between its sources
(the receivers call ``rb_acquire_write``, ``sp_packetize`` ...) bind to its
own code even where another library exporting the same names is loaded::

    g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread -Wl,-Bsymbolic \
        native/*.cpp -o <build>/libdcsand_host_<hash>.so

Its hash covers the sources, the flags, the g++ path and what
``-march=native`` means on the building machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
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
#: Wall seconds each source's ``nvcc`` took in this process's build (empty
#: where the library came from the cache), and ``"link"``'s.
BUILD_SECONDS: dict[str, float] = {}

NATIVE = _PKG / "native"
HOST_SOURCES = ["ringbuffer.cpp", "spead_codec.cpp", "membw.cpp", "udp_burst.cpp", "xdp_burst.cpp"]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-Wl,-Bsymbolic"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C signatures of the launch functions in csrc/ (all return cudaError_t).
_SIGNATURES = {
    "k1_fir_launch": [
        _P, _L, _P, _P,  # x, batch stride (samples), starts [B] int64, window
        _P,  # plane [B, S, fft] bf16
        _I, _I, _I, _I,  # batch, n_spectra, n_taps, fft
        _I, _I, _I, _I,  # the plan: register-ring depth (0: the long body), run, streams a
        # block, short-run body
        _P,  # stream
    ],
    "k1_fir_f32_launch": [
        _P, _L, _P, _P,  # x, batch stride (samples), starts [B] int64, window
        _P,  # plane [B, S, fft] f32
        _I, _I, _I, _I,  # batch, n_spectra, n_taps, fft
        _I, _I, _I, _I,  # the plan: register-ring depth (0: the long body), run, streams a
        # block, short-run body
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
    "k1_dft_attributes": [
        _I, _I,  # n1, n2
        _P,  # out (int[6]): registers, local bytes, KC, K-tile depth, stages, shared-memory bytes
    ],
    "k1_dft_f32_launch": [
        _P,  # plane [B, S, N1, N2] f32
        _P, _P, _P,  # f32 d1c, d1s [N1, N1], d2 stack transposed [N2, N2]
        _P, _P, _P, _P,  # twc, tws [N1, N2], rotc, rots [B, C]
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I, _I,  # batch, n_spectra, n1, n2, quantise
        _P,  # stream
    ],
    "k1_dft_f32_attributes": [
        _I, _I,  # n1, n2
        _P,  # out (int[8]): registers, local bytes, KC, SB, stage-B K-tile depth, stages,
        # shared-memory bytes, threads
    ],
    "k1_stage_a_launch": [
        _P, _P, _P,  # plane [M, N1, N2] bf16, bf16 d1c, d1s [N1, N1]
        _P, _P,  # twc, tws [N1, N2]
        _P, _P,  # T re, im [M, N1, N2] bf16
        _I, _I, _I,  # M (batch * n_spectra), n1, n2
        _P,  # stream
    ],
    "k1_stage_a_f32_launch": [
        _P, _P, _P,  # plane [M, N1, N2] f32, f32 d1c, d1s [N1, N1]
        _P, _P,  # twc, tws [N1, N2]
        _P, _P,  # T re, im [M, N1, N2] f32
        _I, _I, _I,  # M (batch * n_spectra), n1, n2
        _P,  # stream
    ],
    "k1_stage_b_launch": [
        _P, _P, _P,  # T re, im [B, S, N1, N2] bf16, bf16 d2 stack [N2, N2]
        _P, _P,  # rotc, rots [B, C]
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I, _I,  # batch, n_spectra, n1, n2, quantise
        _P,  # stream
    ],
    "k1_stage_b_f32_launch": [
        _P, _P, _P,  # T re, im [B, S, N1, N2] f32, f32 d2 stack transposed [N2, N2]
        _P, _P,  # rotc, rots [B, C]
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I, _I,  # batch, n_spectra, n1, n2, quantise
        _P,  # stream
    ],
    **{name: [
        _I, _I,  # n1, n2
        _P,  # out (int[9]): registers, local bytes, threads, shared-memory bytes, tile rows,
        # tile columns, K-tile depth, stages, blocks an SM
    ] for name in ("k1_stage_a_attributes", "k1_stage_b_attributes",
                   "k1_stage_a_f32_attributes", "k1_stage_b_f32_attributes")},
    "k1_fir_attributes": [
        _I, _I, _I,  # register-ring depth (0: the long body), short-run body, plane_f32
        _P,  # out (int[5]): registers, local bytes, shared bytes, threads, blocks an SM
    ],
    "k1_fir_stop_launch": [
        _P, _L, _P, _P,  # x, batch stride (samples), starts [B] int64, window
        _P, _P, _P,  # plane [B, S, fft] (fir stops), outr, outi [B, S, fft/2]
        _I, _I, _I, _I,  # batch, n_spectra, n_taps, fft
        _I, _I, _I, _I,  # the plan: register-ring depth, run, streams a block, short-run
        _I,  # stop (K1: 1 dma, 9 fir; P5: 1 dma, 2 fir; P2: 5 dma, 6 conv, 7 fir, 8 deint)
        _I, _I, _I,  # N2 (the dma probe's frame view), plane f32 (stop 9), quantise
        _P,  # stream
    ],
    "k1_fir_stop_attributes": [
        _I, _I, _I, _I,  # register-ring depth, short-run body, stop, plane f32 (stop 9) or
        # f32 outputs (stop 1)
        _P,  # out (int[5]), as k1_fir_attributes
    ],
    "k1_dft_stop_launch": [
        _P,  # plane [B, S, N1, N2] bf16
        _P, _P, _P, _P, _P,  # bf16 d1c, d1s, d2 stack; twc, tws
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _I, _I,  # stop (10 stagea, 4 stageb; P5's 3 stagea), quantise
        _P,  # stream
    ],
    "k1_dft_f32_stop_launch": [
        _P,  # plane [B, S, N1, N2] f32
        _P, _P, _P, _P, _P,  # f32 d1c, d1s, d2 stack transposed; twc, tws
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _I, _I,  # stop (10 stagea, 4 stageb), quantise
        _P,  # stream
    ],
    **{name: [
        _I, _I, _I, _I,  # n1, n2, stop, quantise
        _P,  # out (int[3]): registers, local bytes, KC
    ] for name in ("k1_dft_stop_attributes", "k1_dft_f32_stop_attributes")},
    "k1_stage_b_stop_launch": [
        _P, _P, _P,  # T re, im (as stage A wrote them), d2 (bf16 stack, or f32 transposed)
        _P, _P,  # outr, outi [B, S, C] (int8, or f32 without quantise)
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _I, _I,  # f32 operands, quantise
        _P,  # stream
    ],
    "k1_t_slice_launch": [
        _P, _P,  # T re, im (as stage A wrote them)
        _P, _P,  # outr, outi [M, C] (int8, or f32 without quantise)
        _I, _I, _I,  # M (batch * n_spectra), n1, n2
        _I, _I,  # f32 operands, quantise
        _P,  # stream
    ],
    "k1_stage_stop_attributes": [
        _I, _I,  # f32 operands, quantise
        _P,  # out (int[4]): stage B stop's registers, local bytes; the gather's
    ],
    "bstage_fused_launch": [
        _P, _P, _P, _I,  # qr, qi, w, w_is_bf16
        _P,  # out [C/pack, P·S, pack·2B]
        _I, _I, _I, _I,  # n_ants, P·S, n_channels, 2B
        _P,  # stream
    ],
    "bstage_fused_stop_launch": [
        _P, _P, _P, _I,  # qr, qi, w, w_is_bf16
        _P,  # out [C/pack, P·S, pack·2B]
        _I, _I, _I, _I, _I,  # n_ants, P·S, n_channels, 2B, stages (a mask)
        _P,  # stream
    ],
    "bstage_fused_attributes": [
        _I, _I, _I, _I, _I,  # n_ants, P·S, n_channels, 2B, w_is_bf16
        _P,  # out (int[10]): registers, local bytes, blocks, channels, m rows, K rows,
        # resident weights, shared-memory bytes, columns an item, wide plane copies
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
    "xcorr_fused_stop_launch": [
        _P, _P, _P, _P,  # qr, qi [A, P, S, C], vre, vim [C, I, I]
        _I, _I, _I, _I,  # n_inputs, n_spectra, n_channels, stages (a mask)
        _P,  # stream
    ],
    "xcorr_fused_attributes": [
        _I, _I, _I,  # n_inputs, n_spectra, n_channels
        _P, _P, _P,  # out (int*): registers, local bytes, blocks
    ],
    "xcorr_turned_launch": [
        _P, _P, _P,  # xt [C, 2I, S], vre, vim [C, I, I]
        _I, _I, _I,  # n_inputs, n_spectra, n_channels
        _P,  # stream
    ],
    "xcorr_turned_stop_launch": [
        _P, _P, _P,  # xt [C, 2I, S], vre, vim [C, I, I]
        _I, _I, _I, _I,  # n_inputs, n_spectra, n_channels, stages (a mask)
        _P,  # stream
    ],
    "xcorr_turned_attributes": [
        _I, _I, _I,  # n_inputs, n_spectra, n_channels
        _P,  # out (int[8]): registers, local bytes, blocks, plan, stage samples,
        # items a channel, shared-memory bytes, copies by TMA
    ],
    "pfb_fir_launch": [
        _P, _P, _P,  # frames [B, n_frames, F], window [taps, F], out [B, S, F]
        _I, _I, _I, _I,  # batch, n_frames, F, n_spectra
        _I, _I, _I,  # the pass: first tap, taps, register-ring depth (4, 8, 16)
        _I, _I,  # frames are f32, copy mode (0 async, 1 scalar)
        _P,  # stream
    ],
    "pfb_fir_attributes": [
        _I, _I, _I,  # register-ring depth (4, 8, 16), frames are f32, copy mode
        _P, _P, _P,  # out: registers, local bytes, max threads (int*)
    ],
    "dit_dft_launch": [
        _P,  # plane [B, S, fft] bf16
        _P, _P, _P, _P,  # bf16 d1c, d1s [N1, N1], d2c, d2s [N2P, N2P] (N2P = max(N2, 16))
        _P, _P, _P, _P,  # twc, tws [N1, N2], untc, unts [N2, N1]
        _P, _P,  # rotc, rots [B, N]
        _P, _P,  # outr, outi [B, S, N] int8
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _P,  # stream
    ],
    "dit_dft_stop_launch": [
        _P,  # plane [B, S, fft] bf16
        _P, _P, _P, _P, _P, _P,  # bf16 d1c, d1s, d2c, d2s; twc, tws
        _P, _P,  # outr, outi [B, S, N] int8
        _I, _I, _I, _I, _I,  # batch, n_spectra, n1, n2, stop (1 stagea, 2 stageb, 3 stagea T)
        _P,  # stream
    ],
    "dit_dft_attributes": [
        _I, _I,  # n1, n2
        _P,  # out (int[7]): registers, local bytes, KC, stage-B K-tile depth, stages,
        # shared-memory bytes, spectra a unit
    ],
    "dit_dft_f32_launch": [
        _P,  # plane [B, S, fft] f32
        _P, _P, _P,  # f32 d1c, d1s [N1, N1], d2h [NH, N2, 2*N2/NH] (each half of k2 transposed)
        _P, _P, _P, _P,  # twc, tws [N1, N2], untc, unts [N2, N1]
        _P, _P,  # rotc, rots [B, N]
        _P, _P,  # outr, outi [B, S, N] int8
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _P,  # stream
    ],
    "dit_dft_f32_attributes": [
        _I, _I,  # n1, n2
        _P,  # out (int[8]): registers, local bytes, KC, SB, stage-B K-tile depth, stages,
        # shared-memory bytes, threads
    ],
    "dit_stage_b_launch": [
        _P, _P,  # T re, im [B, S, N1, 2*N2] bf16 (K1's stage A on the [N1, 2*N2] view)
        _P, _P,  # bf16 d2c, d2s [N2, N2]
        _P, _P, _P, _P,  # untc, unts [N2, N1], rotc, rots [B, N]
        _P, _P,  # outr, outi [B, S, N] int8
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _P,  # stream
    ],
    "dit_stage_b_f32_launch": [
        _P, _P,  # T re, im [B, S, 2*N2, N1] f32 (K1's f32 stage A on the [N1, 2*N2] view)
        _P,  # f32 d2h [2, N2, N2]
        _P, _P, _P, _P,  # untc, unts [N2, N1], rotc, rots [B, N]
        _P, _P,  # outr, outi [B, S, N] int8
        _I, _I, _I, _I,  # batch, n_spectra, n1, n2
        _P,  # stream
    ],
    **{name: [
        _I, _I,  # n1, n2
        _P,  # out (int[9]): registers, local bytes, threads, shared-memory bytes, tile rows,
        # tile columns, K-tile depth, stages, blocks an SM
    ] for name in ("dit_stage_b_attributes", "dit_stage_b_f32_attributes")},
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


def _reap(proc: subprocess.Popen, name: str, t0: float, done: dict) -> None:
    """Read ``proc``'s output as it ends into ``done["out"]`` and note its
    wall seconds since ``t0`` in :data:`BUILD_SECONDS`."""
    done["out"] = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build() -> Path:
    """Compile ``csrc/*.cu`` (if not cached) and return the library path."""
    nvcc = find_nvcc()
    lib = BUILD_DIR / f"libdcsand_kernels_{_digest(nvcc)}.so"
    if lib.exists():
        return lib
    objdir = BUILD_DIR / f"{lib.stem}.{os.getpid()}.objs"
    objdir.mkdir(parents=True, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    for src in _sources():
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(objdir / f"{src.stem}.o"), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        done: dict = {}
        reader = threading.Thread(target=_reap, args=(proc, src.name, t0, done))
        reader.start()
        jobs.append((cmd, proc, reader, done))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp)]
    link += [str(objdir / f"{src.stem}.o") for src in _sources()]
    try:
        for cmd, proc, reader, done in jobs:  # the first failure raises; `finally` stops the rest
            reader.join()
            out, err = done["out"]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}{out}"
                )
        t1 = time.perf_counter()
        res = subprocess.run(link, capture_output=True, text=True)
        BUILD_SECONDS["link"] = time.perf_counter() - t1
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {res.returncode}): {' '.join(link)}\n"
                f"{res.stderr}{res.stdout}"
            )
    finally:
        for _, proc, reader, _ in jobs:
            if proc.poll() is None:
                proc.kill()
            reader.join()
        shutil.rmtree(objdir, ignore_errors=True)
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def build_host() -> Path | None:
    """Compile ``native/*.cpp`` with g++ (if not cached) and return the
    library path: ``None`` where no ``g++`` is on ``PATH``; a failed build
    raises with g++'s stderr."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    h = hashlib.blake2b(digest_size=8)
    for name in HOST_SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    h.update(" ".join(GXX_FLAGS + [gxx]).encode())
    h.update(target.encode())
    lib = BUILD_DIR / f"libdcsand_host_{h.hexdigest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, *(str(NATIVE / name) for name in HOST_SOURCES), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed (exit {res.returncode}): {' '.join(cmd)}\n{res.stderr}{res.stdout}"
        )
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
