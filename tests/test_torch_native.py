"""The port's host library (``dpdk_dc_sand_tpu_torch/native``) vs the JAX package's.

The library is built by g++ from the port's own sources into
``_kernel_build/``; its ring, codecs, reassembly and RAM scan are held
against the JAX package's native library (``dpdk_dc_sand_tpu.native``) and
against the port's Python paths on the same inputs, made from a seed. Both
libraries export the same C names and are loaded in this one process: each
must run its own code.
"""

import ctypes
import struct

import numpy as np
import pytest

from dpdk_dc_sand_tpu.native import load_native as j_load_native
from dpdk_dc_sand_tpu.stream import spead as j_spead, spead64 as j_spead64
from dpdk_dc_sand_tpu.stream.ring import ChunkRing as JChunkRing
from dpdk_dc_sand_tpu_torch import _build
from dpdk_dc_sand_tpu_torch.characterize import membw
from dpdk_dc_sand_tpu_torch.native import load_native
from dpdk_dc_sand_tpu_torch.stream import spead, spead64
from dpdk_dc_sand_tpu_torch.stream.ring import ChunkRing

P8 = ctypes.POINTER(ctypes.c_uint8)
U64 = ctypes.c_uint64


@pytest.fixture(scope="module")
def lib():
    got = load_native()
    if got is None:
        pytest.skip("no g++ on PATH: the host library cannot be built")
    return got


@pytest.fixture(scope="module")
def jlib():
    got = j_load_native()
    if got is None:
        pytest.skip("the JAX package's native library is unavailable")
    # The JAX package declares no signature for its reassembly entry points.
    got.ub_reasm_create.restype = ctypes.c_void_p
    got.ub_reasm_create.argtypes = [ctypes.c_void_p, U64]
    got.ub_reasm_feed.argtypes = [ctypes.c_void_p, P8, U64]
    got.ub_reasm_stats.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(U64)] * 3
    got.ub_reasm_destroy.argtypes = [ctypes.c_void_p]
    return got


def _buf(b: bytes):
    return (ctypes.c_uint8 * max(len(b), 1)).from_buffer_copy(b + b"\0" * (len(b) == 0))


# ----------------------------------------------------------------------
# The build
# ----------------------------------------------------------------------
def test_library_is_built_from_the_port_sources(lib, jlib):
    path = _build.build_host()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.name == "_kernel_build" and path.parent.parent.name == "dpdk_dc_sand_tpu_torch"
    assert path.name.startswith("libdcsand_host_") and path.suffix == ".so"
    assert lib._name == str(path)
    assert "_dcsand_native" not in lib._name and lib._name != jlib._name
    assert sorted(p.name for p in _build.NATIVE.glob("*.cpp")) == sorted(_build.HOST_SOURCES)
    assert _build.build_host() == path  # cached: same digest, no rebuild
    assert "-Wl,-Bsymbolic" in _build.GXX_FLAGS and "-march=native" in _build.GXX_FLAGS


def _dynamic_flags(path) -> tuple:
    """(DT_SYMBOLIC present, DT_FLAGS value) from an ELF64 shared object."""
    data = path.read_bytes()
    assert data[:4] == b"\x7fELF" and data[4] == 2  # ELF64
    e_phoff, = struct.unpack_from("<Q", data, 0x20)
    e_phentsize, e_phnum = struct.unpack_from("<HH", data, 0x36)
    for i in range(e_phnum):
        p_type, _, p_offset, _, _, p_filesz = struct.unpack_from(
            "<IIQQQQ", data, e_phoff + i * e_phentsize)
        if p_type == 2:  # PT_DYNAMIC
            tags = dict(struct.iter_unpack("<qQ", data[p_offset : p_offset + p_filesz]))
            return 16 in tags, tags.get(30, 0)
    raise AssertionError("no PT_DYNAMIC")


def test_library_binds_its_own_names(lib):
    """Linked with -Bsymbolic: its calls between sources (the receivers'
    rb_acquire_write, sp_packetize, ...) resolve inside the library."""
    symbolic, flags = _dynamic_flags(_build.build_host())
    assert symbolic or flags & 0x2  # DT_SYMBOLIC or DF_SYMBOLIC


def test_no_gxx_means_no_library(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert _build.build_host() is None


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    if _build.shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    for name in _build.HOST_SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error"):
        _build.build_host()
    assert not list((tmp_path / "build").glob("*.so"))


# ----------------------------------------------------------------------
# The ring
# ----------------------------------------------------------------------
def _script(ring) -> list:
    """One sequence of ring operations; every result, as plain values."""
    rng = np.random.default_rng(2021)
    out = []

    def rd():
        item = ring.acquire_read()
        out.append(None if item is None else (bytes(item[0]), item[1]))
        return item

    def wr(nbytes, seq):
        buf = ring.acquire_write()
        out.append(buf is None)
        if buf is not None:
            buf[:nbytes] = rng.integers(0, 256, nbytes, dtype=np.uint8)
            ring.commit_write(nbytes, seq)

    rd()  # empty
    for seq in (5, 9, 13):
        out.append(ring.put(rng.integers(0, 256, 50, dtype=np.uint8), seq))
    wr(10, 1)  # full: acquire_write gives None
    out.append(ring.put(np.zeros(4, np.uint8), 2))  # full: a counted drop
    out.append((len(ring), ring.stats()))
    rd()
    ring.release_read()
    wr(64, 100)
    out.append(ring.put(np.zeros(65, np.uint8), 3))  # larger than a slot: a drop
    ring.count_drop()
    for _ in range(3):
        rd()
        ring.release_read()
    out.append((len(ring), ring.stats()))
    wr(0, 7)
    rd()
    ring.release_read()
    rd()
    out.append((len(ring), ring.stats()))
    return out


def test_ring_semantics_equal_the_jax_native_ring(lib, jlib):
    runs = {}
    for name, ring in (
        ("port native", ChunkRing(3, 64, native=True)),
        ("port python", ChunkRing(3, 64, native=False)),
        ("jax native", JChunkRing(3, 64, native=True)),
        ("jax python", JChunkRing(3, 64, native=False)),
    ):
        try:
            runs[name] = _script(ring)
        finally:
            ring.close()
    assert runs["port native"] == runs["jax native"] == runs["port python"] == runs["jax python"]
    assert runs["port native"][-1] == (0, (5, 5, 3))


def test_native_ring_runs_over_its_own_arena(lib):
    ring = ChunkRing(4, 128, native=True)
    assert ring.native
    buf = ring.acquire_write()
    assert np.shares_memory(buf, ring._arena) and buf.shape == (128,)
    buf[:5] = [1, 2, 3, 4, 5]
    ring.commit_write(5, 42)
    view, seq = ring.acquire_read()
    assert seq == 42 and bytes(view) == b"\x01\x02\x03\x04\x05"
    assert np.shares_memory(view, ring._arena[0])
    ring.release_read()
    ring.close()
    ring.close()  # idempotent
    assert bytes(view) == b"\x01\x02\x03\x04\x05"  # the arena outlives the native ring
    with pytest.raises(ValueError, match="closed"):
        ring.acquire_read()


def test_external_arena_is_not_freed_by_the_ring(lib):
    arena = np.arange(3 * 32, dtype=np.uint8)
    ptr = arena.ctypes.data
    h = lib.rb_create_external(3, 32, ptr)
    assert h
    slot = lib.rb_acquire_write(h)
    assert ctypes.addressof(slot.contents) == ptr
    lib.rb_commit_write(h, 32, 1)
    assert ctypes.addressof(lib.rb_acquire_write(h).contents) == ptr + 32
    lib.rb_destroy(h)
    arena[:] = 7  # still ours to write
    assert int(arena.sum()) == 7 * 96
    assert not lib.rb_create_external(3, 32, None)
    assert not lib.rb_create_external(0, 32, ptr)


# ----------------------------------------------------------------------
# The codecs
# ----------------------------------------------------------------------
SIZES = [0, 1, 1023, 1024, 1025, 4096 * 3, 300_000]


@pytest.mark.parametrize("nbytes", SIZES)
@pytest.mark.parametrize("mtu", [1024, 4096])
def test_packetize_bytes_equal_jax_native_and_port_python(lib, jlib, monkeypatch, nbytes, mtu):
    payload = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    kw = dict(timestamp=123456789012, channel_offset=4096, mtu_payload=mtu)
    native = spead.packetize(payload, heap_id=77, **kw)
    native64 = spead64.packetize64(payload, heap_cnt=77, **kw)
    assert native == j_spead.packetize(payload, heap_id=77, **kw)
    assert native64 == j_spead64.packetize64(payload, heap_cnt=77, **kw)
    monkeypatch.setattr(spead, "load_native", lambda: None)
    monkeypatch.setattr(spead64, "load_native", lambda: None)
    assert native == spead.packetize(payload, heap_id=77, **kw)
    assert native64 == spead64.packetize64(payload, heap_cnt=77, **kw)


def test_parse_and_scatter_equal_jax_native(lib, jlib):
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 10_000, dtype=np.uint8)
    mtu = 1024
    pkts = spead.packetize(payload, heap_id=3, timestamp=99, channel_offset=12, mtu_payload=mtu)
    heaps = {}
    for name, l in (("port", lib), ("jax", jlib)):
        heap = np.zeros(payload.size, np.uint8)
        got = []
        for pkt in pkts + [b"garbage" * 8]:
            outs = [U64(), U64(), ctypes.c_uint32(), ctypes.c_uint16(), ctypes.c_uint16(),
                    ctypes.c_uint32(), ctypes.c_uint32()]
            ok = l.sp_parse_header(_buf(pkt), len(pkt), *map(ctypes.byref, outs))
            n = l.sp_scatter(_buf(pkt), len(pkt), mtu, heap.ctypes.data_as(P8), heap.nbytes)
            got.append((ok, n, [o.value for o in outs] if ok else None))
        heaps[name] = (heap, got)
    np.testing.assert_array_equal(heaps["port"][0], payload)
    np.testing.assert_array_equal(heaps["jax"][0], payload)
    assert heaps["port"][1] == heaps["jax"][1]
    for (ok, n, vals), pkt in zip(heaps["port"][1], pkts):
        hdr = spead.parse_header(pkt)
        assert ok == 1 and n == hdr.payload_len
        assert vals == [hdr.heap_id, hdr.timestamp, hdr.channel_offset, hdr.packet_idx,
                        hdr.n_packets, hdr.payload_len, hdr.heap_len]
    assert heaps["port"][1][-1] == (0, -1, None)


@pytest.mark.parametrize("n_words,chunk_id,counter", [(0, 1, 0), (1, 2, 5), (4096, 7, 42),
                                                      (100_003, 1 << 20, 9)])
def test_pattern_helpers_equal_jax_native_and_port_python(lib, jlib, monkeypatch,
                                                          n_words, chunk_id, counter):
    words = spead.fill_pattern(n_words, chunk_id, counter)
    np.testing.assert_array_equal(words, j_spead.fill_pattern(n_words, chunk_id, counter))
    bad = words.copy()
    if n_words > 10:
        bad[[3, 10, -1]] ^= 1
    got = (spead.check_pattern(words, chunk_id), spead.check_pattern(bad, chunk_id),
           spead.check_pattern(words, chunk_id + 1))
    assert got == (j_spead.check_pattern(words, chunk_id), j_spead.check_pattern(bad, chunk_id),
                   j_spead.check_pattern(words, chunk_id + 1))
    monkeypatch.setattr(spead, "load_native", lambda: None)
    np.testing.assert_array_equal(words, spead.fill_pattern(n_words, chunk_id, counter))
    assert got == (spead.check_pattern(words, chunk_id), spead.check_pattern(bad, chunk_id),
                   spead.check_pattern(words, chunk_id + 1))
    assert got[0] == 0 and got[1] == (3 if n_words > 10 else 0)


# ----------------------------------------------------------------------
# The reassembly, and each library running its own code
# ----------------------------------------------------------------------
def _reassemble(l, ring_handle, pkts, mtu):
    h = l.ub_reasm_create(ring_handle, mtu)
    assert h
    try:
        for pkt in pkts:
            l.ub_reasm_feed(h, _buf(pkt), len(pkt))
        vals = [U64(), U64(), U64()]
        l.ub_reasm_stats(h, *map(ctypes.byref, vals))
        return [v.value for v in vals]  # heaps, ring_drops, evicted
    finally:
        l.ub_reasm_destroy(h)


@pytest.mark.parametrize("wire,sender_mtu", [("lite", 1024), ("spead64", 1024),
                                             ("spead64", 1000), ("spead64", 1536)])
def test_reassembly_counts_each_packet_once(lib, jlib, wire, sender_mtu):
    """A heap with two holes, then the whole heap again (a resend): the
    port's reassembly fills the holes and delivers the heap once, bit for
    bit, and ignores the late duplicates; the JAX library counts bytes, so
    the resend completes the heap with its holes still open. A SPEAD-64-48
    sender may packetize at another size than the receiver's
    ``mtu_payload`` (offsets that are not multiples of it): its packets are
    counted once all the same."""
    mtu = 1024
    payload = np.random.default_rng(3).integers(1, 256, 10 * mtu, dtype=np.uint8)
    if wire == "lite":
        pkts = spead.packetize(payload, heap_id=5, timestamp=11, channel_offset=2, mtu_payload=mtu)
    else:
        pkts = spead64.packetize64(payload, heap_cnt=5, timestamp=11, channel_offset=2,
                                   mtu_payload=sender_mtu)
    holes = [p for i, p in enumerate(pkts) if i not in (3, 7)]
    ring = ChunkRing(4, payload.size + 16, native=True)
    jring = JChunkRing(4, payload.size + 16, native=True)
    try:
        for r in (ring, jring):  # the slot to be filled: zeros mark the holes
            np.asarray(r.acquire_write())[:] = 0
        assert _reassemble(lib, ring._ring, holes + holes[:4], mtu) == [0, 0, 0]
        assert len(ring) == 0  # repeats do not stand in for the holes
        assert _reassemble(lib, ring._ring, holes + pkts, mtu) == [1, 0, 0]
        assert len(ring) == 1
        view, seq = ring.acquire_read()
        assert seq == 5 and struct.unpack_from("<QQ", bytes(view[:16])) == (11, 2)
        np.testing.assert_array_equal(view[16:], payload)
        assert _reassemble(jlib, jring._ring, holes + pkts, mtu)[0] == 1
        jview, jseq = jring.acquire_read()
        assert jseq == 5 and not np.array_equal(np.asarray(jview[16:]), payload)
        # Without repeats both libraries give the same slot bytes.
        ring.release_read()
        jring.release_read()
        assert _reassemble(lib, ring._ring, pkts, mtu) == [1, 0, 0]
        assert _reassemble(jlib, jring._ring, pkts, mtu) == [1, 0, 0]
        np.testing.assert_array_equal(ring.acquire_read()[0], jring.acquire_read()[0])
    finally:
        ring.close()
        jring.close()


def test_both_libraries_in_one_process_keep_their_own_rings(lib, jlib):
    """The same C names in two libraries: each ring's calls stay with its
    library (the port's ring over its arena, the JAX ring over its own)."""
    assert ctypes.cast(lib.rb_acquire_write, ctypes.c_void_p).value != ctypes.cast(
        jlib.rb_acquire_write, ctypes.c_void_p).value
    ring, jring = ChunkRing(2, 32, native=True), JChunkRing(2, 32, native=True)
    try:
        assert ring._lib is lib and jring._lib is jlib
        assert ring.put(np.full(8, 1, np.uint8), 1) and jring.put(np.full(8, 2, np.uint8), 2)
        assert bytes(ring.acquire_read()[0]) == b"\x01" * 8
        assert bytes(jring.acquire_read()[0]) == b"\x02" * 8
        assert ring.stats() == jring.stats() == (1, 0, 0)
    finally:
        ring.close()
        jring.close()


# ----------------------------------------------------------------------
# The RAM scan
# ----------------------------------------------------------------------
def test_membw_scan_is_positive(lib):
    for mode in (0, 1):
        assert lib.membw_scan(2, 1 << 20, 0.02, mode) > 0
    assert lib.membw_scan(1, 100, 0.01, 0) < 0  # below one page a thread
    assert membw.mem_rate(2, 1 << 20, 0.02, "read") > 0
    assert membw._numpy_rate(2, 1 << 20, 0.02, 1) > 0
    with pytest.raises(ValueError, match="membw_scan"):
        membw.mem_rate(1, 100, 0.01)
    rows = membw.mem_rate_sweep((1, 2), 1 << 20, 0.02)
    assert [r[0] for r in rows] == [1, 2] and all(w > 0 and r > 0 for _, w, r in rows)


def test_ctypes_callback_example(lib, capsys, monkeypatch):
    from dpdk_dc_sand_tpu_torch.examples import ctypes_callback

    assert ctypes_callback.native_hot_path() == 0
    assert ctypes_callback.python_callback_from_native() == [1, 2, 3, 4, 5, 7, 8, 9]
    assert "0 mismatches" in capsys.readouterr().out
    monkeypatch.setattr(ctypes_callback, "load_native", lambda: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        ctypes_callback.native_hot_path()
