"""Native ingest ring tests: threading, framing, purge, drop accounting."""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("ctypes")


def _ring():
    from dsdneo_tpu.runtime.native import IngestRing
    return IngestRing(1 << 16)


def test_ring_roundtrip_widen():
    r = _ring()
    raw = np.arange(512, dtype=np.uint8)
    r.write(raw.tobytes())
    blk = r.read_block_cu8(256, timeout_ms=200)
    assert blk is not None and blk.shape == (256, 2)
    expect_i = (raw[0::2].astype(np.float32) / 127.5) - 1.0
    np.testing.assert_allclose(blk[:, 0], expect_i, atol=1e-6)
    r.close()


def test_ring_producer_consumer_threads():
    r = _ring()
    n_blocks = 8
    block = 1024

    def producer():
        rng = np.random.default_rng(0)
        for _ in range(n_blocks):
            r.write(rng.integers(0, 256, 2 * block, dtype=np.uint8).tobytes())
            time.sleep(0.001)

    t = threading.Thread(target=producer)
    t.start()
    got = 0
    for _ in range(n_blocks):
        blk = r.read_block_cu8(block, timeout_ms=1000)
        if blk is not None:
            got += 1
    t.join()
    assert got == n_blocks
    assert r.drops == 0
    r.close()


def test_ring_drop_accounting():
    from dsdneo_tpu.runtime.native import IngestRing
    r = IngestRing(1 << 10)  # 1 KiB
    r.write(bytes(2048))
    assert r.drops >= 1024
    r.close()


def test_ring_purge_generation():
    """Purge is consumer-driven: the control plane only bumps the
    generation; the consumer drains on its next read (keeps `tail`
    single-writer — no racing store from the control thread)."""
    r = _ring()
    r.write(bytes(4096))
    gen0 = r.generation
    r.purge()
    assert r.generation == gen0 + 1
    # pre-purge data is abandoned by the consumer's next read
    blk = r.read_block_cu8(128, timeout_ms=50)
    assert blk is None
    assert r.fill == 0
    # post-purge writes flow normally
    r.write(bytes(512))
    blk = r.read_block_cu8(128, timeout_ms=200)
    assert blk is not None
    r.close()


def test_ring_purge_concurrent_consumer():
    """A purge racing an active consumer must not resurrect pre-purge
    bytes: after the consumer observes the purge, only post-purge data
    is ever returned."""
    from dsdneo_tpu.runtime.native import IngestRing
    r = IngestRing(1 << 16)
    stop = threading.Event()

    def producer():
        junk = bytes([0xAA]) * 512
        while not stop.is_set():
            r.write(junk)
            time.sleep(0.0002)

    t = threading.Thread(target=producer)
    t.start()
    try:
        for _ in range(20):
            r.read_block_cu8(64, timeout_ms=20)
            r.purge()
            # first read after a purge abandons the block
            while r.read_block_cu8(64, timeout_ms=20) is None:
                if r.generation == 0:
                    break
    finally:
        stop.set()
        t.join()
    stop.set()
    # marker write after everything quiesced: purge, then only the
    # fresh marker may surface
    r.purge()
    assert r.read_block_cu8(64, timeout_ms=20) is None   # drain purge
    r.write(bytes([0x55]) * 128)
    blk = r.read_block_cu8(64, timeout_ms=200)
    assert blk is not None
    expect = (0x55 / 127.5) - 1.0
    np.testing.assert_allclose(blk[:, 0], expect, atol=1e-6)
    r.close()


def test_ring_fs4_rotation():
    r = _ring()
    # constant I=+1, Q=0 input → rotation cycles through (1, ±j, -1, ∓j)
    raw = np.zeros(16, dtype=np.uint8)
    raw[0::2] = 255
    raw[1::2] = 128
    r.write(raw.tobytes())
    blk = r.read_block_cu8(8, rotate=1, timeout_ms=200)
    assert blk is not None
    i = blk[:, 0]
    assert i[0] > 0.9 and abs(i[1]) < 0.02 and i[2] < -0.9
    r.close()


def test_ring_purge_preserves_post_purge_writes():
    """The purge watermark is the head at purge time: samples produced
    AFTER the retune request must survive to the next read."""
    r = _ring()
    r.write(bytes([0xAA]) * 512)     # pre-purge: dropped
    r.purge()
    r.write(bytes([0x55]) * 128)     # post-purge: kept
    assert r.read_block_cu8(64, timeout_ms=50) is None   # purge drain
    blk = r.read_block_cu8(64, timeout_ms=200)
    assert blk is not None
    expect = (0x55 / 127.5) - 1.0
    np.testing.assert_allclose(blk[:, 0], expect, atol=1e-6)
    r.close()


def test_ring_truncated_write_keeps_cu8_parity():
    """Odd TCP chunks and overflowing writes must never flip the CU8
    I/Q byte parity: the wrapper stashes a dangling odd byte, so the
    ring only sees whole samples and truncation drops whole samples."""
    from dsdneo_tpu.runtime.native import IngestRing
    r = IngestRing(capacity=1 << 10)        # 1024 bytes
    assert r.write(bytes(1021)) == 1020     # odd byte stashed
    assert r.fill == 1020                   # free space 4
    assert r.write(bytes(range(8))) == 4    # 1+8 → stash 1, write 8→4
    assert r.fill == 1024 and r.fill % 2 == 0
    assert r.drops % 2 == 0 and r.drops == 4
    # the dangling byte from write 1 leads the second write's payload
    out = r.read_block_cu8(512, timeout_ms=50)
    assert out is not None
    # sample 510 = bytes (stash=0x00 of write1? no: write1 bytes(1021)
    # are zeros; its stashed zero + 0,1,2 of write 2) → pairs
    # (0, 0) then (1, 2) at samples 510 and 511
    import numpy as np
    b = np.round((out[510:, :] + 1.0) * 127.5).astype(int)
    assert b.tolist() == [[0, 0], [1, 2]]
    r.close()


def test_ring_widen_timeout_consumes_nothing():
    """read_block_cu8 is all-or-nothing: a timeout with a partial
    block buffered must not consume (and then discard) the partial
    data — the samples belong to the NEXT successful read."""
    import numpy as np
    from dsdneo_tpu.runtime.native import IngestRing
    r = IngestRing(capacity=1 << 16)
    half = bytes(range(100)) * 10           # 1000 bytes = 500 samples
    r.write(half)
    assert r.read_block_cu8(1000, timeout_ms=50) is None
    assert r.fill == 1000                   # nothing consumed
    r.write(half)
    out = r.read_block_cu8(1000, timeout_ms=50)
    assert out is not None and out.shape == (1000, 2)
    # first sample is the FIRST byte pair written, not a later one
    exp_i = 0 / 127.5 - 1.0
    exp_q = 1 / 127.5 - 1.0
    assert abs(out[0, 0] - exp_i) < 1e-6 and abs(out[0, 1] - exp_q) < 1e-6
    assert r.fill == 0
    r.close()


def test_library_named_by_source_hash(tmp_path, monkeypatch):
    """The built library's name carries a hash of the committed C++
    sources: an edited source gets a fresh build, and a stale binary
    copied in from elsewhere is never loaded under the new name."""
    import os

    from dsdneo_tpu.runtime import native
    srcs = []
    for src in native._SRCS:
        dst = tmp_path / os.path.basename(src)
        dst.write_bytes(open(src, "rb").read())
        srcs.append(str(dst))
    monkeypatch.setattr(native, "_SRCS", srcs)
    before = native._so_path()
    assert os.path.basename(before).startswith("libdsdneo_ingest-")
    assert native._so_path() == before
    with open(srcs[1], "a") as f:
        f.write("\n// edited\n")
    assert native._so_path() != before
