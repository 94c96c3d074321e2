"""Batched P25 Phase 2 TDMA control-channel monitor (engine.ccbatch.
BatchedP2ControlPipeline): the reference trunks TDMA LCCH control
channels via state->p25_cc_is_tdma (src/protocol/p25/p25_trunk_sm.c:289,
phase2/p25p2_vpdu.c MAC handling); here the xCCH bursts screen through
two GF(2) matmuls (systematic RS(63,35) encode map + CRC12 table) and
only errored bursts fall back to the serial Berlekamp–Massey decode."""

import numpy as np
import pytest

WACN, SYSID, NAC = 0xBEE00, 0x14C, 0x293
CENTER = 851_000_000.0
GRANT_CH = (1 << 12) | 24
TG = 101


def _cc_iq(n_sf=3, msgs=None, wacn=WACN, sysid=SYSID, nac=NAC, seed=0):
    from dsdneo_tpu.protocol.p25 import encode as E
    return E.p2_cc_iq(n_sf, msgs, wacn, sysid, nac, seed)


def _planes(blk):
    return np.stack([blk.real, blk.imag], axis=-1).astype(np.float32)


def _default_msgs():
    from dsdneo_tpu.protocol.p25 import encode as E
    return E.p2_cc_default_msgs(CENTER, GRANT_CH, TG, WACN, SYSID)


def test_encode_matrix_matches_rs_encode():
    from dsdneo_tpu.protocol.p25 import p2_xcch
    rng = np.random.default_rng(1)
    for kind, n in (("sacch", 180), ("facch", 156)):
        M = p2_xcch.xcch_encode_matrix(kind)
        for _ in range(4):
            payload = rng.integers(0, 2, n).astype(np.uint8)
            want = p2_xcch.xcch_rs_encode(payload, kind)
            got = (payload.astype(np.int32) @ M.astype(np.int32)) % 2
            np.testing.assert_array_equal(got, want)


def test_crc12_matrix_matches_crc12():
    from dsdneo_tpu.protocol.p25 import p2_xcch
    rng = np.random.default_rng(2)
    for n in (168, 144):
        T = p2_xcch.crc12_matrix(n)
        for _ in range(4):
            bits = rng.integers(0, 2, n).astype(np.uint8)
            v = (bits.astype(np.int32) @ T.astype(np.int32)) % 2
            got = 0
            for b in v:
                got = (got << 1) | int(b)
            assert got ^ 0xFFF == p2_xcch.crc12_of(bits, n)


def test_p2_cc_grants_parse_clean():
    """Clean CC: every MAC PDU takes the matmul fast path (zero RS
    fallbacks) and grants/iden/net-sts all land."""
    from dsdneo_tpu.engine.ccbatch import BatchedP2ControlPipeline
    iq = _cc_iq(msgs=_default_msgs())
    C = 2
    blk = np.broadcast_to(iq, (C, len(iq))).copy()
    pipe = BatchedP2ControlPipeline(C, fs=48000.0, wacn=WACN,
                                    sysid=SYSID, nac=NAC)
    n = pipe.decode_block_events(_planes(blk))
    assert n >= 30 * C
    assert pipe.rs_fallbacks == 0 and pipe.crc_errors == 0
    for c in range(C):
        grants = [e for e in pipe.ctxs[c].events if e.fields.get("grant")]
        assert grants and grants[0].fields["tg"] == TG
        assert grants[0].fields["channel"] == GRANT_CH
        s = pipe.ctxs[c].state
        assert s.p2_wacn == WACN and s.p2_sysid == SYSID
        assert s.iden_table.entries[1][3] == 2       # 2-slot TDMA iden


def test_p2_cc_blind_scramble_recovery():
    """With no configured identity the CC's scramble parameters are
    recovered from RS parity linearity mid-block; later blocks ride
    the fast screen.  The reference needs -X or an (unscrambled)
    NET_STS for this (p25p2_vpdu.c)."""
    from dsdneo_tpu.engine.ccbatch import BatchedP2ControlPipeline
    iq = _cc_iq()
    pipe = BatchedP2ControlPipeline(1, fs=48000.0)
    pipe.decode_block_events(_planes(iq[None, :]))
    s = pipe.ctxs[0].state
    assert (s.p2_wacn, s.p2_sysid, s.p2_cc) == (WACN, SYSID, NAC)
    assert any("recovered" in e.line for e in pipe.ctxs[0].events)
    n2 = pipe.decode_block_events(_planes(iq[None, :]))
    assert n2 >= 30 and pipe.rs_fallbacks == 0


def test_p2_cc_errored_burst_rs_fallback():
    """Channel errors push a burst off the matmul screen into the
    serial RS(63,35) erasure decode, which corrects it."""
    from dsdneo_tpu.engine.ccbatch import BatchedP2ControlPipeline
    from dsdneo_tpu.protocol.p25 import encode as E
    iq = _cc_iq(n_sf=2, msgs=_default_msgs(), seed=3)
    # corrupt ~10 symbols inside ts0's payload region (dibits 45-55 of
    # the timeslot: bits 90-110, well clear of the DUID codeword bits
    # at 0/1/74/75/244/245/318/319 so the burst still types as SACCH)
    bad = iq.copy()
    k0 = int((40 + 20 + 45) / 6000.0 * 48000)
    k1 = int((40 + 20 + 55) / 6000.0 * 48000)
    bad[k0:k1] = np.exp(1j * np.linspace(0, 9, k1 - k0)
                        ).astype(np.complex64)
    pipe = BatchedP2ControlPipeline(1, fs=48000.0, wacn=WACN,
                                    sysid=SYSID, nac=NAC)
    n = pipe.decode_block_events(_planes(bad[None, :]))
    assert pipe.rs_fallbacks >= 1
    assert n >= 15          # the rest of the CC still parses
    grants = [e for e in pipe.ctxs[0].events if e.fields.get("grant")]
    assert grants
