"""Batched control-channel pipelines (engine.ccbatch): device
TSBK/CSBK decode vs the serial host decoders on the real CC fixtures.
"""

import os

import numpy as np
import pytest

from dsdneo_tpu.protocol.nxdn.encode import cac_stream_iq as _build_cac_stream

pytestmark = pytest.mark.slow      # full-tier only (docs/testing.md)

FIXDIR = "/root/reference/tests/fixtures/iq"


def _fixture_iq(name: str):
    from dsdneo_tpu.io import read_iq_capture
    meta, samples = read_iq_capture(os.path.join(FIXDIR, name + ".iq.json"))
    iq = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    return float(meta.sample_rate_hz), iq


def test_bptc_device_matches_host():
    from dsdneo_tpu.engine.ccbatch import bptc_196_96_decode_batch
    from dsdneo_tpu.fec import bptc
    rng = np.random.default_rng(7)
    words, want_p, want_e = [], [], []
    for i in range(64):
        payload = rng.integers(0, 2, 96).astype(np.uint8)
        w = bptc.bptc_196_96_encode(payload)
        # up to 2 injected bit errors
        for j in rng.choice(196, size=i % 3, replace=False):
            w[j] ^= 1
        p, e = bptc.bptc_196_96_decode(w)
        words.append(w)
        want_p.append(p)
        want_e.append(e)
    got_p, got_e = bptc_196_96_decode_batch(np.stack(words))
    np.testing.assert_array_equal(np.asarray(got_p), np.stack(want_p))
    np.testing.assert_array_equal(np.asarray(got_e), np.asarray(want_e))


def test_crc16_screen_matches_host():
    import jax.numpy as jnp
    from dsdneo_tpu.engine.ccbatch import _crc16_screen
    from dsdneo_tpu.fec import crc as crcmod
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2, (32, 96)).astype(np.uint8)
    # make half of them CRC-valid with the TSBK mask
    for i in range(0, 32, 2):
        v = crcmod.crc16_bits(words[i, :80], init=0, xorout=0xFFFF)
        words[i, 80:96] = [(v >> (15 - j)) & 1 for j in range(16)]
    got = np.asarray(_crc16_screen(jnp.asarray(words), 0xFFFF))
    for i in range(32):
        v = crcmod.crc16_bits(words[i, :80], init=0, xorout=0xFFFF)
        want = 0
        for b in words[i, 80:96]:
            want = (want << 1) | int(b)
        assert got[i] == (v == want)


def _serial_tsbk_lines(fs, iq):
    from dsdneo_tpu.engine.decoder import decode_samples
    ctx = decode_samples(iq[:, 0] + 1j * iq[:, 1], "p25p1", fs=fs)
    return [e.line for e in ctx.events]


def test_p25_cc_pipeline_matches_serial():
    from dsdneo_tpu.engine.ccbatch import BatchedP25ControlPipeline
    fs, iq1 = _fixture_iq("p25p1_c4fm_cc")
    C = 3
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    pipe = BatchedP25ControlPipeline(C, fs=fs)
    n = pipe.decode_block_events(iq)
    assert n > 10, "expected a stream of CRC-valid TSBKs on the CC fixture"

    serial = _serial_tsbk_lines(fs, iq1)
    serial_payload = [l for l in serial
                      if not l.startswith("Sync:") and "CRC ERR" not in l]
    for c in range(C):
        lines = [e.line for e in pipe.events(c)]
        payload = [l for l in lines
                   if not l.startswith("Sync:") and "CRC ERR" not in l]
        # every serial-path TSBK payload line must appear on the
        # batched path (same catalog, same CRC gate)
        missing = [l for l in serial_payload if l not in payload]
        assert not missing, f"channel {c} missing TSBKs: {missing[:3]}"
        assert any("TSDU" in l for l in lines)


def test_p25_cc_parse_cache_equivalent():
    from dsdneo_tpu.engine.ccbatch import BatchedP25ControlPipeline
    fs, iq1 = _fixture_iq("p25p1_c4fm_cc")
    iq = iq1[None]
    a = BatchedP25ControlPipeline(1, fs=fs, parse_cache=True)
    b = BatchedP25ControlPipeline(1, fs=fs, parse_cache=False)
    a.decode_block_events(iq)
    b.decode_block_events(iq)
    # run a second identical block: the cache path must re-emit the
    # exact same event stream the uncached parse produces
    a.decode_block_events(iq)
    b.decode_block_events(iq)
    la = [e.line for e in a.events(0)]
    lb = [e.line for e in b.events(0)]
    assert la == lb


def test_dmr_cc_pipeline_decodes_csbk():
    from dsdneo_tpu.engine.ccbatch import BatchedDmrControlPipeline
    fs, iq1 = _fixture_iq("dmr_t3_cc")
    C = 2
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    pipe = BatchedDmrControlPipeline(C, fs=fs)
    n = pipe.decode_block_events(iq)
    assert n > 5, "expected CRC-valid CSBKs on the Tier III CC fixture"
    lines = [e.line for e in pipe.events(0)]
    # the fixture's CC traffic (Connect Plus) must parse with details
    assert any("| CSBK | " in l for l in lines), lines[:8]


def test_dmr_cc_matches_serial_csbk_set():
    """Every CSBK detail the serial decoder parses from the fixture
    must also come out of the batched path."""
    from dsdneo_tpu.engine.ccbatch import BatchedDmrControlPipeline
    from dsdneo_tpu.engine.decoder import decode_samples
    fs, iq1 = _fixture_iq("dmr_t3_cc")
    ctx = decode_samples(iq1[:, 0] + 1j * iq1[:, 1], "dmr", fs=fs)
    serial_csbk = set()
    for e in ctx.events:
        if "| CSBK" in e.line and "CRC ERR" not in e.line:
            serial_csbk.add(e.line.split("| CSBK", 1)[1])
    pipe = BatchedDmrControlPipeline(1, fs=fs)
    pipe.decode_block_events(iq1[None])
    batched_csbk = set()
    for e in pipe.events(0):
        if "| CSBK" in e.line and "CRC ERR" not in e.line:
            batched_csbk.add(e.line.split("| CSBK", 1)[1])
    missing = serial_csbk - batched_csbk
    assert not missing, f"batched path missing CSBKs: {list(missing)[:3]}"


def test_cc_events_feed_trunk_follower():
    """Grants parsed by the batched CC path drive TrunkFollower."""
    from dsdneo_tpu.engine.ccbatch import BatchedP25ControlPipeline
    from dsdneo_tpu.engine.trunk import TrunkFollower, TrunkSM
    fs, iq1 = _fixture_iq("p25p1_c4fm_cc")
    pipe = BatchedP25ControlPipeline(1, fs=fs)
    pipe.decode_block_events(iq1[None])
    tuned = []
    sm = TrunkSM(tune=lambda f, why: tuned.append((f, why)) or True)
    fol = TrunkFollower(sm, pipe.ctxs[0])
    for ev in pipe.events(0):
        fol.on_event(ev)
    # the CC fixture carries iden_up + grants; whether a tune fires
    # depends on fixture content — the contract here is no crashes and
    # the follower consumed every event
    assert isinstance(tuned, list)


def test_p25_cc_pipeline_cqpsk():
    """LSM/CQPSK control channel through the batched CC pipeline: the
    cqpsk front end swaps in (the chain after the soft symbols is
    modulation-agnostic) and the TSBK catalog decodes the cqpsk CC
    fixture, matching the serial path's payload set."""
    from dsdneo_tpu.engine.ccbatch import BatchedP25ControlPipeline
    fs, iq1 = _fixture_iq("p25p1_cqpsk_cc")
    pipe = BatchedP25ControlPipeline(1, fs=fs, cqpsk=True)
    n = pipe.decode_block_events(iq1[None])
    assert n > 10
    from dsdneo_tpu.engine.decoder import decode_samples
    ctx = decode_samples(iq1[:, 0] + 1j * iq1[:, 1], "p25p1", fs=fs,
                         cqpsk=True)
    serial_payload = [e.line for e in ctx.events
                      if not e.line.startswith("Sync:")
                      and "CRC ERR" not in e.line]
    lines = [e.line for e in pipe.events(0)]
    missing = [l for l in serial_payload if l not in lines]
    assert not missing, f"missing: {missing[:3]}"
    assert any("WACN" in l for l in lines)   # Network Status decoded


def test_conv_k5_device_matches_host():
    """Batched device K=5 Viterbi vs the host decoder: identical bits
    on punctured soft inputs with injected errors."""
    import jax.numpy as jnp
    from dsdneo_tpu.fec import conv
    from dsdneo_tpu.fec.device import conv_k5_decode_batch
    rng = np.random.default_rng(5)
    syms, wts, want = [], [], []
    for i in range(24):
        bits = rng.integers(0, 2, 171).astype(np.uint8)
        enc = conv.encode(bits).astype(np.float32)     # 2*(171+4)
        wt = np.ones_like(enc)
        # puncture ~15% and flip a few bits
        punct = rng.choice(enc.size, size=enc.size // 7, replace=False)
        wt[punct] = 0.0
        for j in rng.choice(enc.size, size=i % 4, replace=False):
            enc[j] = 1.0 - enc[j]
        dec = conv.decode_soft(enc, wt, nbits=175)
        syms.append(enc)
        wts.append(wt)
        want.append(dec)
    got = np.asarray(conv_k5_decode_batch(jnp.asarray(np.stack(syms)),
                                          jnp.asarray(np.stack(wts))))
    np.testing.assert_array_equal(got, np.stack(want))


def test_nxdn_cc_pipeline_matches_serial():
    """NXDN RCCH monitoring: the batched CAC path (device depermute +
    depuncture + K=5 Viterbi + CRC screen) parses the same message set
    the serial decoder extracts from the nxdn48 fixture."""
    from dsdneo_tpu.engine.ccbatch import BatchedNxdnControlPipeline
    from dsdneo_tpu.engine.decoder import decode_samples
    fs, iq1 = _fixture_iq("nxdn48")
    ctx = decode_samples(iq1[:, 0] + 1j * iq1[:, 1], "nxdn48", fs=fs)
    serial_cac = [e.line.split("CAC", 1)[1] for e in ctx.events
                  if "CAC" in e.line and "CRC ERR" not in e.line]
    pipe = BatchedNxdnControlPipeline(1, fs=fs)
    n = pipe.decode_block_events(iq1[None])
    batched = [e.line.split("CAC", 1)[1] for e in pipe.events(0)
               if "CAC" in e.line and "CRC ERR" not in e.line]
    if serial_cac:
        missing = [l for l in serial_cac if l not in batched]
        assert not missing, f"missing CACs: {missing[:3]}"
        assert n >= len(serial_cac)
    else:
        # the 48 fixture is an RTCH voice capture; the pipeline must
        # simply not fabricate CACs from it
        assert n == 0




def test_nxdn_cc_synthetic_cac_roundtrip():
    """Positive CAC validation (the off-air fixtures carry no RCCH):
    spec-built RCCH frames decode through the batched device path with
    exact message recovery at the 192-dibit frame stride."""
    from dsdneo_tpu.engine.ccbatch import BatchedNxdnControlPipeline
    samples = _build_cac_stream(n_frames=4, seed=3)
    iq = np.stack([samples.real, samples.imag],
                  axis=-1).astype(np.float32)[None]
    pipe = BatchedNxdnControlPipeline(1, fs=48000.0)
    n = pipe.decode_block_events(iq)
    assert n == 4, f"parsed {n} CACs (errors {pipe.crc_errors})"
    assert all("CAC RAN 05" in e.line for e in pipe.events(0))


def test_edacs_cc_pipeline_matches_serial():
    """Batched EDACS monitor vs the serial decoder on the edacs
    fixture: the device vote + dual-polarity BCH screen parses the
    same message set."""
    from dsdneo_tpu.engine.ccbatch import BatchedEdacsControlPipeline
    from dsdneo_tpu.engine.decoder import decode_samples
    fs, iq1 = _fixture_iq("edacs")
    ctx = decode_samples(iq1[:, 0] + 1j * iq1[:, 1], "edacs", fs=fs)
    serial = [e.line for e in ctx.events
              if "EDACS" in e.line and "BCH FAIL" not in e.line]
    serial_words = {e.fields.get("word") for e in ctx.events
                    if "word" in e.fields}
    assert serial, "serial path decoded nothing"
    pipe = BatchedEdacsControlPipeline(1, fs=fs)
    n = pipe.decode_block_events(iq1[None])
    assert n > 5
    got_words = {e.fields.get("word") for e in pipe.events(0)
                 if "word" in e.fields}
    missing = serial_words - got_words
    assert len(missing) <= max(1, 0.1 * len(serial_words)), (
        f"missing {len(missing)}/{len(serial_words)} words")
