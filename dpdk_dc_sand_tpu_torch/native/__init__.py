"""The host library: native (C++) runtime components, loaded with ctypes (counterpart of ``dpdk_dc_sand_tpu/native``).

The reference keeps its transport and characterisation hot paths in
C/C++ (dpdk_send_recv/, ibverbs_sample_project/, utilities/), and so does
the port: an SPSC chunk ring buffer (``ringbuffer.cpp``, which can also
run over a caller's page-locked arena), the SPEAD-lite and SPEAD-64-48
packet codecs (``spead_codec.cpp``), the RAM-bandwidth scanner
(``membw.cpp``), and the burst-UDP (``udp_burst.cpp``) and AF_XDP
(``xdp_burst.cpp``) engines. The sources are the port's own copies; they
compile at first use with g++ into ``_kernel_build/``
(:func:`dpdk_dc_sand_tpu_torch._build.build_host`).

:func:`load_native` returns ``None`` only where no ``g++`` is on ``PATH``;
there the ring, the codecs and the RAM scan take their Python paths. Where
g++ exists, a failed build or load raises: a broken library does not hide
behind the Python paths.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from dpdk_dc_sand_tpu_torch import _build

_LOCK = threading.Lock()
_CACHED: Optional[ctypes.CDLL] = None
_TRIED = False


def load_native() -> Optional[ctypes.CDLL]:
    """The host library, built if necessary; ``None`` where there is no g++."""
    global _CACHED, _TRIED
    with _LOCK:
        if not _TRIED:
            path = _build.build_host()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _CACHED = lib
            _TRIED = True
        return _CACHED


def _declare(lib: ctypes.CDLL) -> None:
    """The C signatures (those of ``dpdk_dc_sand_tpu/native/build.py``, and
    the port's ``rb_create_external``, ``sp64_parse`` and ``ub_reasm_*``)."""
    u64, u32, u16 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint16
    p8 = ctypes.POINTER(ctypes.c_uint8)
    vp = ctypes.c_void_p
    cs = ctypes.c_char_p
    pu64 = ctypes.POINTER(u64)
    sigs = {
        # ringbuffer.cpp
        "rb_create": (vp, [u64, u64]),
        "rb_create_external": (vp, [u64, u64, vp]),
        "rb_destroy": (None, [vp]),
        "rb_slot_bytes": (u64, [vp]),
        "rb_capacity": (u64, [vp]),
        "rb_acquire_write": (p8, [vp]),
        "rb_commit_write": (None, [vp, u64, u64]),
        "rb_count_drop": (None, [vp]),
        "rb_acquire_read": (p8, [vp, pu64, pu64]),
        "rb_release_read": (None, [vp]),
        "rb_size": (u64, [vp]),
        "rb_stats": (None, [vp, pu64, pu64, pu64]),
        "rb_count_consumed": (None, [vp]),
        # spead_codec.cpp
        "sp_header_bytes": (u64, []),
        "sp_packetize": (u64, [p8, u64, u64, u64, u32, u64, p8, u64]),
        "sp_parse_header": (ctypes.c_int, [
            p8, u64, pu64, pu64, ctypes.POINTER(u32), ctypes.POINTER(u16),
            ctypes.POINTER(u16), ctypes.POINTER(u32), ctypes.POINTER(u32),
        ]),
        "sp_scatter": (ctypes.c_longlong, [p8, u64, u64, p8, u64]),
        "sp_fill_pattern": (None, [pu64, u64, u64, u64]),
        "sp_check_pattern": (u64, [pu64, u64, u64]),
        "sp64_header_bytes": (u64, []),
        "sp64_packetize": (u64, [p8, u64, u64, u64, u32, u64, p8, u64]),
        "sp64_parse": (ctypes.c_int, [
            p8, u64, pu64, pu64, ctypes.POINTER(u32), pu64, ctypes.POINTER(u32),
            ctypes.POINTER(u32), ctypes.POINTER(u32),
        ]),
        "sp64_patch_fragment": (None, [p8, u64, u64]),
        # membw.cpp
        "membw_scan": (ctypes.c_double, [u32, u64, ctypes.c_double, u32]),
        # udp_burst.cpp
        "ub_sender_create": (vp, [cs, u16, u64]),
        "ub_sender_create_mode": (vp, [cs, u16, u64, ctypes.c_int]),
        "ub_sender_mode": (ctypes.c_int, [vp]),
        "ub_send_chunk": (ctypes.c_longlong, [vp, p8, u64, u64, u64, u32]),
        "ub_sender_stats": (None, [vp, pu64, pu64]),
        "ub_sender_destroy": (None, [vp]),
        "ub_receiver_create": (vp, [cs, u16, cs, u64, vp]),
        "ub_receiver_create_mode": (vp, [cs, u16, cs, u64, vp, ctypes.c_int]),
        "ub_receiver_mode": (ctypes.c_int, [vp]),
        "ub_receiver_port": (u16, [vp]),
        "ub_receiver_stats": (None, [vp, pu64, pu64, pu64, pu64, pu64]),
        "ub_receiver_destroy": (None, [vp]),
        "ub_reasm_create": (vp, [vp, u64]),
        "ub_reasm_feed": (None, [vp, p8, u64]),
        "ub_reasm_stats": (None, [vp, pu64, pu64, pu64]),
        "ub_reasm_destroy": (None, [vp]),
        # xdp_burst.cpp
        "xsk_last_fail_stage": (ctypes.c_int, []),
        "xsk_last_fail_errno": (ctypes.c_int, []),
        "xsk_sender_create": (vp, [cs, cs, cs, u16, u16, u64]),
        "xsk_sender_create_fmt": (vp, [cs, cs, cs, u16, u16, u64, ctypes.c_int]),
        "xsk_send_chunk": (ctypes.c_longlong, [vp, p8, u64, u64, u64, u32]),
        "xsk_sender_stats": (None, [vp, pu64, pu64]),
        "xsk_sender_destroy": (None, [vp]),
        "xsk_receiver_create": (vp, [cs, u16, u64, vp]),
        "xsk_receiver_create_multi": (vp, [cs, ctypes.POINTER(u16), ctypes.c_int, u64, vp]),
        "xsk_receiver_stats": (None, [vp, pu64, pu64, pu64, pu64, pu64]),
        "xsk_receiver_destroy": (None, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
