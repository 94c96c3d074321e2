"""Codebook-ML and slicer decisions on the GPU at deployment width.

A float32 contraction may run in TF32 on the card, and a TF32 flip near
a tie changes a decoded bit.  Every decision-feeding contraction asks
for ``Precision.HIGHEST``; these tests hold each batched decoder at
C=320 on the GPU to its host decoder run on the CPU device of the same
process: decoded frames, FEC bits, slot types, CSBKs and picks
bit-exact, and PCM within ``PCM_TOL`` of peak (the f16 wire and the
backends' own exp/sin/cos and summation order; -34 dB, below the
vocoders' quantization noise).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

C = 320
PCM_TOL = 2e-2


def _cpu():
    import jax
    return jax.default_device(jax.devices("cpu")[0])


def _planes(x, n):
    iq1 = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.broadcast_to(iq1[None], (n,) + iq1.shape).copy()


def _pcm_close(got, ref):
    k = min(got.shape[-1], ref.shape[-1])
    peak = float(np.abs(ref).max())
    assert peak > 0
    assert float(np.abs(got[..., :k] - ref[..., :k]).max()) <= PCM_TOL * peak


def test_p25p1_voice_frames_and_fec_match_serial_decoder():
    """Front-end conv + timing pickup + sync + NID + IMBE ECC."""
    from dsdneo_tpu.engine.decoder import decode_samples
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.fec import device as fdev
    from dsdneo_tpu.protocol.p25 import encode as E
    from dsdneo_tpu.protocol.p25.imbe_frame import decode_imbe_ecc
    x = E.voice_capture(2.0, seed=5)
    with _cpu():
        ctx = decode_samples(x, "p25p1", fs=48000.0)
        ref_pcm = BatchedP25VoicePipeline(1).decode_block(_planes(x, 1))
    ref = np.stack([np.asarray(f, np.uint8) for ev in ctx.events
                    if "imbe" in ev.fields for f in ev.fields["imbe"]])
    pipe = BatchedP25VoicePipeline(C)
    dib, bd, bs, nm = pipe.frontend_sync(_planes(x, C))
    f144, fch, _ = pipe.find_voice_frames_best(dib, bd, bs, dib.shape[1], nm)
    b88 = np.asarray(fdev.imbe_ecc_batch(f144)[0])
    ref88 = np.stack([decode_imbe_ecc(f)[0] for f in ref])
    for c in range(C):
        got = f144[fch == c]
        assert len(got) == len(ref)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(b88[fch == c], ref88)
    _pcm_close(pipe.decode_block(_planes(x, C)), ref_pcm)


def test_dmr_voice_emb_gate_matches_host():
    """dmrbatch EMB QR(16,7,6) codebook argmax feeding the superframe
    pick, then the AMBE chain to PCM."""
    from dsdneo_tpu.engine.dmrbatch import (BatchedDmrVoicePipeline,
                                            synth_voice_stream)
    x, _d, _b = synth_voice_stream(n_superframes=4, seed=3)

    def picks(pipe, iq):
        fe = pipe.frontend_sync_device(iq)
        ac, at, ai, _fch, _ford = pipe.pick_superframes(*fe[1:])
        return ac, at, ai, pipe.decode_block(iq)

    with _cpu():
        rc, rt, ri, rpcm = picks(BatchedDmrVoicePipeline(1), _planes(x, 1))
    ac, at, ai, pcm = picks(BatchedDmrVoicePipeline(C), _planes(x, C))
    assert len(rc) >= 6
    for c in range(C):
        np.testing.assert_array_equal(at[ac == c], rt)
        np.testing.assert_array_equal(ai[ac == c], ri)
    # unvoiced-band noise phases follow the row index: row 0 only
    _pcm_close(pcm[:1], rpcm[:1])


def _dmr_cc_iq():
    from dsdneo_tpu.protocol.dmr import encode as DE
    from dsdneo_tpu.protocol.p25.encode import c4fm_iq
    grant = DE.tv_grant_csbk(lpcn=24, ts=0, tg=101, src=5555)
    idle = DE.csbk_bits(25, 0, bytes(8))
    csbks = [grant if i % 3 == 0 else idle for i in range(30)]
    return c4fm_iq(DE.cc_stream_dibits(csbks, cc=1), sps=10, fs=48000.0,
                   seed=1)


def _csbks(lines):
    """Distinct CSBK details (the serial decoder also annotates the
    CACH's short link control, which the CC pipeline does not read)."""
    return {ln.split("| CSBK", 1)[1].split("\n")[0] for ln in lines
            if "| CSBK" in ln and "CRC ERR" not in ln.split("\n")[0]}


def test_dmr_cc_slot_type_matches_serial_decoder():
    """ccbatch Golay(20,8) slot-type codebook argmax on the TSCC."""
    from dsdneo_tpu.engine.ccbatch import BatchedDmrControlPipeline
    from dsdneo_tpu.engine.decoder import decode_samples
    x = _dmr_cc_iq()
    with _cpu():
        want = _csbks(e.line for e in decode_samples(x, "dmr").events)
    assert want
    pipe = BatchedDmrControlPipeline(C)
    pipe.decode_block_events(_planes(x, C))
    for c in range(C):
        assert _csbks(e.line for e in pipe.events(c)) == want


@pytest.mark.parametrize("body", ["dmr_voice", "dmr_cc", "p2_voice"])
def test_sharded_family_bodies_match_host(body):
    """parallel.mesh codebook argmaxes: DMR EMB, DMR slot type, P25p2
    DUID and ISCH, each on a one-card mesh at C=320 against the same
    program on the CPU."""
    import jax
    from jax.sharding import Mesh

    from dsdneo_tpu.engine.dmrbatch import synth_voice_stream
    from dsdneo_tpu.engine.p2batch import synth_p2_voice_stream
    from dsdneo_tpu.parallel import mesh as M

    def run(n, dev):
        m = Mesh(np.array([dev]), ("ch",))
        if body == "dmr_voice":
            x, _d, _b = synth_voice_stream(n_superframes=3, seed=3)
            iq = _planes(x, n)
            step, sh = M.make_sharded_dmr_voice_step(m, n, iq.shape[1],
                                                     max_sf=3)
            return np.asarray(step(jax.device_put(iq, sh))[0])
        if body == "p2_voice":
            x, _d, _b = synth_p2_voice_stream(n_superframes=3, seed=1)
            iq = _planes(x, n)
            step, sh = M.make_sharded_p2_voice_step(m, n, iq.shape[1],
                                                    max_frames=3)
            return np.asarray(step(jax.device_put(iq, sh))[0])
        iq = _planes(_dmr_cc_iq(), n)
        fn = jax.jit(M._dmr_cc_body(n, iq.shape[1], max_csbks=16))
        blobs, valid = fn(jax.device_put(iq, dev))[:2]
        return np.asarray(blobs), np.asarray(valid)

    ref = run(1, jax.devices("cpu")[0])
    got = run(C, jax.devices()[0])
    if body == "dmr_cc":
        # CRC-valid CSBK payloads per channel (candidate order and
        # shoulder duplicates follow the scores, not the decisions)
        def payloads(blob, valid):
            ok = blob[valid]
            return {bytes(r[:12]) for r in ok[ok[:, 12] == 1]}
        want = payloads(ref[0][0], ref[1][0])
        assert want
        for c in range(C):
            assert payloads(got[0][c], got[1][c]) == want
        return
    # channel 0 (P25p2: its two slot rows); unvoiced-band noise phases
    # follow the row index, so rows beyond it differ by design
    rows = 2 if body == "p2_voice" else 1
    assert np.abs(got).max(axis=1).min() > 0
    _pcm_close(got[:rows], ref[:rows])
