"""Batched voice pipeline: vectorized dequantizer parity + full-chain
equivalence against the event-driven decoder on the real fixture."""

import numpy as np
import pytest

from dsdneo_tpu.vocoder import imbe
from dsdneo_tpu.vocoder.batch import BatchedImbeDecoder

pytestmark = pytest.mark.slow      # full-tier only (docs/testing.md)


def test_batched_dequantizer_matches_per_frame():
    """BatchedImbeDecoder.step must be bit-identical (well, float-
    identical) to chained imbe.decode_frame per channel."""
    rng = np.random.default_rng(0)
    C, Tn = 5, 12
    dec = BatchedImbeDecoder(C)
    prevs = [None] * C
    for t in range(Tn):
        S = rng.integers(0, 2, (C, 88)).astype(np.uint8)
        active = rng.uniform(size=C) > 0.2
        w0, L, voiced, amps = dec.step(S, active)
        for c in range(C):
            if not active[c]:
                assert w0[c] == 0 and L[c] == 0
                continue
            p = imbe.decode_frame(S[c], prevs[c])
            prevs[c] = p
            assert L[c] == p.L
            np.testing.assert_allclose(w0[c], p.w0, rtol=1e-6)
            # voiced per harmonic
            for l in range(p.L):
                band = min(l // 3, p.K - 1)
                assert voiced[c, l] == p.voiced_bands[band]
            from dsdneo_tpu.vocoder.mbe import _IMBE_AMP_SCALE
            expect = (2.0 ** np.clip(p.log_m, -4.0, 14.0)) * _IMBE_AMP_SCALE
            np.testing.assert_allclose(amps[c, :p.L], expect, rtol=1e-5)
            assert not amps[c, p.L:].any()


def test_pipeline_matches_event_decoder_on_fixture():
    """The batched pipeline (device sync + batched NID + window
    extraction + batched ECC) must recover the same IMBE parameter bits
    as the event-driven P25P1Decoder run over the SAME symbol stream."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.io import read_iq_capture
    from dsdneo_tpu.protocol import base as proto_base
    from dsdneo_tpu.protocol.p25.imbe_frame import decode_imbe_ecc
    from dsdneo_tpu.protocol.p25.phase1 import P25P1Decoder
    from dsdneo_tpu.symbols import framesync
    from dsdneo_tpu.fec import device as fdev

    meta, samples = read_iq_capture(
        "/root/reference/tests/fixtures/iq/p25p1_c4fm_vc.iq.json")
    C = 3
    iq = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq[None], (C,) + iq.shape).copy()
    pipe = BatchedP25VoicePipeline(C)
    dib_j, soft_j, _ = pipe.frontend(iq)
    dib, soft = np.asarray(dib_j), np.asarray(soft_j)

    # event-driven decode over the same stream (channel 0)
    defs = framesync.patterns_for({"p25p1"})
    hits = framesync.find_syncs(soft[0], defs, threshold=0.62)
    ctx = proto_base.DecoderContext()
    dec = P25P1Decoder()
    consumed = 0
    for h in hits:
        if h.pos < consumed or h.sync.inverted:
            continue
        reader = proto_base.DibitReader(dib[0], soft[0], pos=h.end,
                                        frame_start=h.pos)
        consumed = dec.handle(reader, h, ctx)
    ref = []
    for ev in ctx.events:
        if "imbe" in ev.fields:
            for fr in ev.fields["imbe"]:
                ref.append(decode_imbe_ecc(fr)[0])
    assert len(ref) >= 60

    frames144, fch, forder = pipe.find_voice_frames(dib, soft)
    assert frames144.shape[0] > 0
    bits88 = np.asarray(fdev.imbe_ecc_batch(frames144)[0])
    for c in range(C):
        got = bits88[fch == c]
        # LDUs whose tail crosses the capture end are skipped by the
        # batched hunter; compare the common prefix
        n = min(len(got), len(ref))
        assert n >= 60
        for i in range(n):
            np.testing.assert_array_equal(got[i], ref[i], err_msg=f"c{c} f{i}")


def test_pipeline_produces_pcm():
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.io import read_iq_capture
    meta, samples = read_iq_capture(
        "/root/reference/tests/fixtures/iq/p25p1_c4fm_vc.iq.json")
    C = 2
    iq = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq[None], (C,) + iq.shape).copy()
    pipe = BatchedP25VoicePipeline(C)
    pcm = pipe.decode_block(iq)
    assert pcm.shape[0] == C and pcm.shape[1] >= 60 * 160
    rms = np.sqrt((pcm ** 2).mean())
    assert np.isfinite(pcm).all() and rms > 1e-4


def test_device_decode_matches_host():
    """The single-dispatch device decode (ECC+dequant+prediction+synth
    in one jit) must match the host two-pass decode_block_host path on
    the real fixture (tolerance covers the host path's f16 amps
    quantization before synth)."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.io import read_iq_capture
    meta, samples = read_iq_capture(
        "/root/reference/tests/fixtures/iq/p25p1_c4fm_vc.iq.json")
    C = 2
    iq = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq[None], (C,) + iq.shape).copy()
    a = BatchedP25VoicePipeline(C).decode_block(iq)
    b = BatchedP25VoicePipeline(C).decode_block_host(iq)
    n = min(a.shape[1], b.shape[1])
    assert n > 0 and a.shape[1] % n == 0
    # padded tail (if any) must be silence
    assert not np.abs(a[:, n:]).any() or np.abs(a[:, n:]).max() < 1e-6
    scale = np.abs(b[:, :n]).max()
    np.testing.assert_allclose(a[:, :n], b[:, :n], atol=2e-2 * scale)


def test_two_pass_dequant_matches_step():
    """decode_transforms + run_prediction must equal the one-pass
    BatchedImbeDecoder.step chain exactly."""
    from dsdneo_tpu.vocoder.batch import (BatchedImbeDecoder,
                                          decode_transforms, run_prediction)
    rng = np.random.default_rng(4)
    C, Tn = 6, 10
    S_seq = [rng.integers(0, 2, (C, 88)).astype(np.uint8) for _ in range(Tn)]
    acts = [rng.uniform(size=C) > 0.25 for _ in range(Tn)]

    ref = BatchedImbeDecoder(C)
    two = BatchedImbeDecoder(C)
    for S, act in zip(S_seq, acts):
        a = ref.step(S, act)
        T_all, w0_all, L_all, K_all = decode_transforms(S)
        b = run_prediction(two, T_all, w0_all, L_all, K_all, S, act)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)


def test_cqpsk_batched_voice_pipeline():
    """The LSM/CQPSK voice fixture decodes through the batched pipeline
    with the feed-forward CQPSK front end (cqpsk=True): same
    sync/NID/LDU/vocoder machinery after the soft symbols."""
    import os
    fx = "/root/reference/tests/fixtures/iq/p25p1_cqpsk_vc.iq.json"
    if not os.path.exists(fx):
        import pytest
        pytest.skip("reference fixtures unavailable")
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.io import read_iq_capture
    meta, samples = read_iq_capture(fx)
    iq = np.stack([samples.real, samples.imag],
                  axis=-1).astype(np.float32)[None]
    pipe = BatchedP25VoicePipeline(1, fs=float(meta.sample_rate_hz),
                                   cqpsk=True)
    dibits_dev, idx, vq, dq, msg, n_sym = pipe.frontend_sync_device(iq)
    ac, at, fch, forder = pipe.pick_ldus(idx, vq, dq, msg, n_sym)
    assert ac.size >= 2, f"only {ac.size} LDUs accepted on CQPSK"
    pcm = pipe.decode_block(iq)
    assert pcm.shape[1] >= ac.size * 9 * 160
    assert np.abs(pcm).max() > 0
    # the C4FM front end must NOT find LDUs in an LSM capture
    c4 = BatchedP25VoicePipeline(1, fs=float(meta.sample_rate_hz))
    d2, i2, v2, q2, m2, n2 = c4.frontend_sync_device(iq)
    a2, *_ = c4.pick_ldus(i2, v2, q2, m2, n2)
    assert a2.size <= ac.size


def test_deep_pipeline_stages_match_decode_block():
    """frontend_dispatch → frontend_finish → decode_from_frontend must
    equal the one-call decode_block (the deep-pipelined driver path)."""
    import os
    fx = "/root/reference/tests/fixtures/iq/p25p1_c4fm_vc.iq.json"
    if not os.path.exists(fx):
        import pytest
        pytest.skip("reference fixtures unavailable")
    import numpy as np
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.io import read_iq_capture
    meta, samples = read_iq_capture(fx)
    fs = float(meta.sample_rate_hz)
    iq = np.stack([samples.real, samples.imag],
                  axis=-1).astype(np.float32)[None]
    a = BatchedP25VoicePipeline(1, fs=fs)
    b = BatchedP25VoicePipeline(1, fs=fs)
    ref = a.decode_block(iq)
    fe = b.frontend_dispatch(iq)
    h = b.decode_from_frontend(b.frontend_finish(fe))
    out = b.fetch_pcm(h)
    np.testing.assert_array_equal(np.asarray(ref), out)
