"""M17 TX → RX loopback: the encoder's output must decode through the
full receive chain (dibit level and modulated-baseband level)."""

import numpy as np
import pytest


def _decode_dibits(dibits):
    from dsdneo_tpu.protocol.base import DecoderContext, DibitReader, registry
    import dsdneo_tpu.protocol.m17  # noqa: F401
    from dsdneo_tpu.symbols import framesync

    lv = np.array([1.0, 3.0, -1.0, -3.0], dtype=np.float32)
    soft = lv[dibits]
    hits = framesync.find_syncs(soft, framesync.patterns_for({"m17"}),
                                threshold=0.9)
    ctx = DecoderContext()
    dec = registry()["m17"]()
    reader_cls = DibitReader
    consumed = 0
    for h in hits:
        if h.pos < consumed:
            continue
        r = reader_cls(dibits, soft, pos=h.end, frame_start=h.pos,
                       invert=h.sync.inverted)
        consumed = dec.handle(r, h, ctx)
    return ctx


def test_m17_stream_loopback_dibits():
    from dsdneo_tpu.protocol.m17.encoder import encode_stream_transmission
    rng = np.random.default_rng(0)
    voice = rng.integers(0, 2, (12, 128)).astype(np.uint8)
    dibits = encode_stream_transmission("BROADCAST", "N0CALL", voice, can=7)
    ctx = _decode_dibits(dibits)
    text = "\n".join(e.line for e in ctx.events)
    assert "SRC: N0CALL" in text
    assert "DST: BROADCAST" in text
    assert "CAN: 7" in text
    assert "LC: 6/6" in text


def test_m17_lsf_frame_loopback():
    from dsdneo_tpu.protocol.m17.encoder import (SYNC_LSF, build_lsf,
                                                 encode_lsf_frame)
    lsf = build_lsf("W1AW", "N0CALL", can=3)
    dibits = np.concatenate([
        np.array([3, 1] * 8, dtype=np.uint8),
        np.array(SYNC_LSF, dtype=np.uint8),
        encode_lsf_frame(lsf),
    ])
    ctx = _decode_dibits(dibits)
    text = "\n".join(e.line for e in ctx.events)
    assert "SRC: N0CALL" in text and "DST: W1AW" in text


def test_m17_packet_loopback():
    from dsdneo_tpu.protocol.m17.encoder import encode_packet_transmission
    msg = "Greetings from the GPU side of the house! " * 2
    dibits = encode_packet_transmission("W1AW", "N0CALL", msg, can=2)
    ctx = _decode_dibits(dibits)
    text = "\n".join(e.line for e in ctx.events)
    assert "SRC: N0CALL" in text and " Packet" in text
    assert f"SMS: {msg}" in text


def test_m17_bert_loopback():
    from dsdneo_tpu.protocol.m17.encoder import encode_bert_transmission
    dibits = encode_bert_transmission(6)
    ctx = _decode_dibits(dibits)
    lines = [e.line for e in ctx.events if "BRT" in e.line]
    assert len(lines) == 6
    # receiver must lock within the first frames and then run error-free
    assert "LOCK" in lines[-1]
    assert "errors:0" in lines[-1]
    last_bits = int(lines[-1].split("bits:")[1].split()[0])
    assert last_bits >= 3 * 197


def test_m17_modulated_loopback():
    """Encode → 4FSK baseband → the full DSP front-end → decode."""
    import jax
    from dsdneo_tpu.engine.decoder import decode_samples
    from dsdneo_tpu.protocol.m17.encoder import (dibits_to_baseband,
                                                 encode_stream_transmission)
    rng = np.random.default_rng(1)
    voice = rng.integers(0, 2, (8, 128)).astype(np.uint8)
    dibits = encode_stream_transmission("BROADCAST", "KC1AAA", voice)
    x = dibits_to_baseband(dibits, sps=10, dev=0.15)
    # small noise + padding like a real capture
    pad = (rng.normal(size=500) + 1j * rng.normal(size=500)).astype(np.complex64) * 0.05
    x = np.concatenate([pad, x, pad])
    ctx = decode_samples(x, "m17")
    text = "\n".join(e.line for e in ctx.events)
    assert "SRC: KC1AAA" in text


def test_m17_signed_stream_loopback_verifies():
    """Signed stream TX → RX: TYPE bit 11 advertises the signature,
    the 4 tail frames (FN 7FFC..FFFF) carry r||s, and the decoder's
    rolling digest verifies against the matching public key
    (reference m17.c:888-935, m17_parse.c:53-105)."""
    from dsdneo_tpu.crypto.ecdsa import p256_public_key
    from dsdneo_tpu.protocol.m17.encoder import encode_stream_transmission

    priv = 0x51E9F0C37A2B18D4655F00AA13C2DD08B7E6419C25A3F8706D5B2E8C91437AF0
    pub = p256_public_key(priv)
    rng = np.random.default_rng(3)
    voice = rng.integers(0, 2, (12, 128)).astype(np.uint8)
    dibits = encode_stream_transmission("BROADCAST", "N0CALL", voice,
                                        sign_key=priv)
    ctx = _decode_dibits(dibits)
    text = "\n".join(e.line for e in ctx.events)
    assert "SIG:" in text and "COMPLETE;" in text
    # without a pubkey configured: NO PUBKEY (status untouched)
    assert "NO PUBKEY;" in text

    ctx2 = _decode_dibits(dibits)


def test_m17_signed_stream_with_pubkey_and_tamper():
    from dsdneo_tpu.crypto.ecdsa import p256_public_key
    from dsdneo_tpu.protocol.m17.encoder import encode_stream_transmission

    priv = 0x51E9F0C37A2B18D4655F00AA13C2DD08B7E6419C25A3F8706D5B2E8C91437AF0
    pub = p256_public_key(priv)
    rng = np.random.default_rng(4)
    voice = rng.integers(0, 2, (8, 128)).astype(np.uint8)
    dibits = encode_stream_transmission("BROADCAST", "N0CALL", voice,
                                        sign_key=priv)

    from dsdneo_tpu.protocol.base import DecoderContext, DibitReader, registry
    import dsdneo_tpu.protocol.m17  # noqa: F401
    from dsdneo_tpu.symbols import framesync

    def run(dib, pubkey):
        lv = np.array([1.0, 3.0, -1.0, -3.0], dtype=np.float32)
        soft = lv[dib]
        hits = framesync.find_syncs(soft, framesync.patterns_for({"m17"}),
                                    threshold=0.9)
        ctx = DecoderContext()
        ctx.state.m17_pubkey = pubkey
        dec = registry()["m17"]()
        consumed = 0
        for h in hits:
            if h.pos < consumed:
                continue
            r = DibitReader(dib, soft, pos=h.end, frame_start=h.pos,
                            invert=h.sync.inverted)
            consumed = dec.handle(r, h, ctx)
        return ctx

    ctx = run(dibits, pub)
    text = "\n".join(e.line for e in ctx.events)
    assert "VERIFIED;" in text
    assert ctx.state.m17_sig_status == "valid"

    # wrong key -> verify fail
    bad = p256_public_key(priv + 1)
    ctx3 = run(dibits, bad)
    assert "VERIFY FAIL;" in "\n".join(e.line for e in ctx3.events)
