"""P25 Phase 1 frame SYNTHESIS: TSDU/LDU dibit streams + C4FM I/Q.

The reference generates its I/Q regression fixtures with an offline
tool (tools/build_iq_fixtures.py, provenance docs/testing.md:33-66);
this module is the rebuild's equivalent generator — real BCH NID, real
1/2-rate trellis TSBKs with CRC16, real IMBE ECC voice frames, status
dibits on the 36-dibit grid — so control-channel + trunking tests and
benches can run on synthesized wideband material (the reference ships
no multi-channel capture at all).

Layouts mirror the decode side exactly:
  - NID read order / status stripping: protocol/p25/phase1.py _read_nid
    (reference src/engine/dispatch/dispatch_p25p1.c:86-141)
  - TSDU: 3 trellis blocks (reference p25p1_tsbk.c:1054 processTSBK)
  - LDU voice-frame offsets: engine/voicebatch.py LDU_IMBE_OFFSETS
    (reference p25p1_ldu1.c:185-286)
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu.fec import blockcodes, crc, trellis

def _p25_sync_dibits() -> np.ndarray:
    from dsdneo_tpu.symbols import framesync
    d = next(x for x in framesync.SYNC_DEFS if x.name == "+P25p1")
    return np.asarray([int(c) for c in d.pattern], dtype=np.uint8)


SYNC_DIBITS = _p25_sync_dibits()


def nid_dibits(nac: int, duid: int) -> np.ndarray:
    """BCH(63,16)-encoded NID + 1 pad bit → 32 dibits."""
    code = blockcodes.bch_63_16().encode(((nac & 0xFFF) << 4) | (duid & 0xF))
    bits64 = np.concatenate([code, np.zeros(1, np.uint8)])
    return ((bits64[0::2] << 1) | bits64[1::2]).astype(np.uint8)


def tsbk_bytes(opcode: int, args: bytes | list[int], mfid: int = 0,
               lb: bool = False) -> np.ndarray:
    """One 12-byte TSBK: header + 8 argument bytes + CRC16(xor 0xFFFF)."""
    b = np.zeros(12, dtype=np.uint8)
    b[0] = (0x80 if lb else 0) | (opcode & 0x3F)
    b[1] = mfid & 0xFF
    a = list(args)
    b[2:2 + len(a)] = a
    bits = np.unpackbits(b[:10])
    v = crc.crc16_bits(bits, init=0, xorout=0xFFFF)
    b[10] = (v >> 8) & 0xFF
    b[11] = v & 0xFF
    return b


def iden_up_tsbk(iden: int, base_hz: float, spacing_hz: float,
                 offset_hz: float = 0.0, bw: int = 0x4,
                 lb: bool = False) -> np.ndarray:
    """Identifier Update (opcode 0x3D): channel→frequency math record
    (decode side: phase1._iden_update; reference p25_frequency.c)."""
    base = int(round(base_hz / 5.0))
    spac = int(round(spacing_hz / 125.0)) & 0x3FF
    raw = int(round(abs(offset_hz) / 250e3)) & 0xFF
    sign = 1 if offset_hz >= 0 else 0
    args = [
        ((iden & 0xF) << 4) | ((bw >> 5) & 0xF),
        ((bw & 0x1F) << 3) | (sign << 2) | ((raw >> 6) & 3),
        ((raw & 0x3F) << 2) | ((spac >> 8) & 3),
        spac & 0xFF,
        (base >> 24) & 0xFF, (base >> 16) & 0xFF,
        (base >> 8) & 0xFF, base & 0xFF,
    ]
    return tsbk_bytes(0x3D, args, lb=lb)


def iden_up_tdma_tsbk(iden: int, base_hz: float, spacing_hz: float,
                      offset_hz: float = 0.0, chan_type: int = 3,
                      lb: bool = False) -> np.ndarray:
    """Identifier Update for TDMA (opcode 0x33): like iden_up but the
    channel-type nibble marks the slots/channel (3 → 2-slot Phase 2;
    decode side: phase1._iden_update chan_type slots map; reference
    p25_frequency.c TDMA iden records)."""
    base = int(round(base_hz / 5.0))
    spac = int(round(spacing_hz / 125.0)) & 0x3FF
    raw = int(round(abs(offset_hz) / 250e3)) & 0x1FFF
    sign = 1 if offset_hz >= 0 else 0
    args = [
        ((iden & 0xF) << 4) | (chan_type & 0xF),
        (sign << 7) | ((raw >> 6) & 0x7F),
        ((raw & 0x3F) << 2) | ((spac >> 8) & 3),
        spac & 0xFF,
        (base >> 24) & 0xFF, (base >> 16) & 0xFF,
        (base >> 8) & 0xFF, base & 0xFF,
    ]
    return tsbk_bytes(0x33, args, lb=lb)


def group_grant_tsbk(channel16: int, tg: int, src: int, svc: int = 0,
                     lb: bool = False) -> np.ndarray:
    """Group Voice Channel Grant (opcode 0x00): svc@2 chan@3-4
    group@5-6 src@7-9 (decode side: phase1._tsbk opcode 0x00)."""
    args = [svc & 0xFF,
            (channel16 >> 8) & 0xFF, channel16 & 0xFF,
            (tg >> 8) & 0xFF, tg & 0xFF,
            (src >> 16) & 0xFF, (src >> 8) & 0xFF, src & 0xFF]
    return tsbk_bytes(0x00, args, lb=lb)


def _with_status(data_dibits: np.ndarray, start: int = 24) -> np.ndarray:
    """Insert status dibits (value 0) so data lands only at raw stream
    positions q (relative to frame start) with q % 36 != 35 — the
    inverse of voicebatch._status_strip_map."""
    out = []
    q = start
    for d in data_dibits:
        while q % 36 == 35:
            out.append(0)
            q += 1
        out.append(int(d))
        q += 1
    return np.asarray(out, dtype=np.uint8)


def tsdu_frame(nac: int, payloads: list[np.ndarray]) -> np.ndarray:
    """One TSDU frame (sync + NID + up to 3 TSBK trellis blocks) as a
    raw dibit stream with status dibits in place.  The LAST payload
    should carry the Last Block flag (tsbk_bytes lb=True)."""
    assert 1 <= len(payloads) <= 3
    data = [nid_dibits(nac, 0x7)]
    for p in payloads:
        bits196 = trellis.p25_12_encode(np.unpackbits(np.asarray(p, np.uint8)))
        data.append(((bits196[0::2] << 1) | bits196[1::2]).astype(np.uint8))
    body = _with_status(np.concatenate(data), start=len(SYNC_DIBITS))
    return np.concatenate([SYNC_DIBITS, body])


def ldu_frame(nac: int, frames144: np.ndarray, duid: int = 5,
              seed: int = 0) -> np.ndarray:
    """One LDU frame: sync + NID + 9 ECC'd IMBE frames ([9, 144] bits)
    at the voicebatch LDU offsets; LCW/LSD gap dibits are random."""
    from dsdneo_tpu.engine.voicebatch import (LDU_DATA_DIBITS,
                                              LDU_IMBE_OFFSETS)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4, 32 + LDU_DATA_DIBITS).astype(np.uint8)
    data[:32] = nid_dibits(nac, duid)
    for j, off in enumerate(LDU_IMBE_OFFSETS):
        b = np.asarray(frames144[j], dtype=np.uint8)
        data[32 + off:32 + off + 72] = (b[0::2] << 1) | b[1::2]
    body = _with_status(data, start=len(SYNC_DIBITS))
    return np.concatenate([SYNC_DIBITS, body])


def c4fm_iq(dibits: np.ndarray, sps: int = 10, fs: float = 48000.0,
            dev_hz: float = 1800.0, snr_db: float = 30.0,
            seed: int = 0) -> np.ndarray:
    """Dibit stream → complex C4FM-style baseband (same shaping as the
    DSP unit tests' generator, tests/test_dsp.py synth_c4fm)."""
    lv = np.array([1.0, 3.0, -1.0, -3.0])[np.asarray(dibits)]
    inst = np.repeat(lv, sps) * (dev_hz / 3.0)
    k = max(sps // 2, 1)
    inst = np.convolve(inst, np.ones(k) / k, mode="same")
    phase = 2 * np.pi * np.cumsum(inst) / fs
    x = np.exp(1j * phase)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + noise * 10 ** (-snr_db / 20)).astype(np.complex64)


def random_voice_ldus(n_ldus: int, seed: int = 0) -> np.ndarray:
    """[n_ldus, 9, 144] ECC'd IMBE voice frames with coherent random
    parameters (through the real quantizer + ECC encoders)."""
    from dsdneo_tpu.protocol.p25.imbe_frame import encode_imbe_ecc
    from dsdneo_tpu.vocoder.imbe import ImbeParams, encode_frame, \
        harmonics_for_b0
    rng = np.random.default_rng(seed)
    w0, L, K = harmonics_for_b0(80)
    out = np.zeros((n_ldus, 9, 144), dtype=np.uint8)
    prev = None
    for i in range(n_ldus):
        for j in range(9):
            p = ImbeParams(b0=80, w0=w0, L=L, K=K,
                           voiced_bands=np.ones(K, np.uint8),
                           log_m=rng.uniform(1.0, 5.0, size=L),
                           gain_code=40)
            out[i, j] = encode_imbe_ecc(encode_frame(p, prev))
            prev = p
    return out


def voice_capture(seconds: float = 3.0, fs: float = 48000.0,
                  nac: int = 0x293, seed: int = 0) -> np.ndarray:
    """Seeded P25 Phase 1 C4FM voice capture: back-to-back LDU1/LDU2
    frames whose IMBE voice frames pass through the real quantizer and
    ECC encoders, as ``int(seconds * fs)`` complex64 samples."""
    rng = np.random.default_rng(seed)
    sps = int(round(fs / 4800.0))
    ldu_s = 864 / 4800.0                     # one LDU is 864 dibits
    n_ldus = int(np.ceil(seconds / ldu_s)) + 1
    ldus = random_voice_ldus(n_ldus, seed=seed)
    dib = [rng.integers(0, 4, 30).astype(np.uint8)]
    for i, ldu in enumerate(ldus):
        dib.append(ldu_frame(nac, ldu, duid=5 if i % 2 == 0 else 10,
                             seed=seed + i))
    x = c4fm_iq(np.concatenate(dib), sps=sps, fs=fs, seed=seed + 1)
    return x[:int(seconds * fs)]


# band layout of :func:`trunked_band` (a 16-channel 768 kHz raster)
BAND_FS = 768000.0
BAND_CENTER_HZ = 851_000_000.0
BAND_CC_OFF = -96_000          # control channel at 850.904 MHz
BAND_VC_OFF = 150_000          # granted voice channel at 851.150 MHz
BAND_TG = 101


def trunked_band(seconds: float = 2.0, seed: int = 0,
                 tg: int = BAND_TG) -> np.ndarray:
    """Seeded wideband P25 site at ``BAND_FS``: a control channel that
    repeats an iden (6.25 kHz raster), a group voice grant of ``tg``
    on the voice channel and a network status broadcast,
    plus LDU voice on that channel.  Returns complex64 samples scaled
    to a peak magnitude of 1 (ready for a CU8 capture)."""
    rng = np.random.default_rng(seed)
    sps = int(BAND_FS / 4800)
    nac = 0x293
    grant_ch = (1 << 12) | 24                # iden 1, channel 24
    netstat = tsbk_bytes(0x3B, [0, 0x92, 0x06, 0x50, 0xD5, 0, 0, 0],
                         lb=True)
    iden = iden_up_tsbk(1, BAND_CENTER_HZ, 6250.0)
    frame = tsdu_frame(nac, [iden, group_grant_tsbk(grant_ch, tg=tg,
                                                    src=5555), netstat])
    need = int(seconds * 4800)
    cc_dib, total = [rng.integers(0, 4, 60).astype(np.uint8)], 60
    while total < need:
        cc_dib.append(frame)
        cc_dib.append(rng.integers(0, 4, 24).astype(np.uint8))
        total += len(frame) + 24
    cc = c4fm_iq(np.concatenate(cc_dib)[:need], sps=sps, fs=BAND_FS,
                 seed=seed + 1)
    ldus = random_voice_ldus(int(seconds / 0.185) + 1, seed=seed + 3)
    vc_dib = [rng.integers(0, 4, 30).astype(np.uint8)]
    for i, ldu in enumerate(ldus):
        vc_dib.append(ldu_frame(nac, ldu, duid=5 if i % 2 == 0 else 10,
                                seed=seed + i))
    vc = c4fm_iq(np.concatenate(vc_dib), sps=sps, fs=BAND_FS, seed=seed + 2)
    n = int(seconds * BAND_FS)
    t = np.arange(n, dtype=np.float64) / BAND_FS
    wide = np.zeros(n, dtype=np.complex128)
    for x, off in ((cc, BAND_CC_OFF), (vc, BAND_VC_OFF)):
        m = min(len(x), n)
        wide[:m] += x[:m] * np.exp(2j * np.pi * off * t[:m])
    return (wide / (np.abs(wide).max() or 1.0)).astype(np.complex64)


# -- P25 Phase 2 TDMA control channel ----------------------------------------
def p2_mac_payload(header: int, messages: list[list[int]],
                   kind: str = "sacch") -> np.ndarray:
    """MAC PDU payload bits for one xCCH burst: 3-bit header opcode in
    octet 0, message octets from octet 1, CRC12 (inverted) in the last
    12 bits (decode side: phase2._mac_pdu + p2_mac.P2MacWalker;
    reference p25p2_xcch.c process_SACCH_MAC_PDU)."""
    from dsdneo_tpu.protocol.p25 import p2_xcch
    nbits = 180 if kind == "sacch" else 156
    octs = [(header & 7) << 5]
    for msg in messages:
        octs.extend(int(b) & 0xFF for b in msg)
    n_oct = nbits // 8
    if len(octs) > n_oct:
        raise ValueError(f"{len(octs)} octets exceed the {kind} payload")
    payload = np.zeros(nbits, dtype=np.uint8)
    for i, o in enumerate(octs):
        for j in range(8):
            payload[8 * i + j] = (o >> (7 - j)) & 1
    nd = nbits - 12
    crc = p2_xcch.crc12_of(payload, nd)
    for j in range(12):
        payload[nd + j] = (crc >> (11 - j)) & 1
    return payload


def p2_mac_net_sts(wacn: int, sysid: int, chan16: int = 0x2114,
                   lra: int = 0) -> list[int]:
    """Network Status Broadcast MAC message (op 0x7B, bridged to the
    P1 0x3B parser which learns WACN/SYS for the P2 scrambler)."""
    return [0x7B, lra & 0xFF,
            (wacn >> 12) & 0xFF, (wacn >> 4) & 0xFF,
            ((wacn & 0xF) << 4) | ((sysid >> 8) & 0xF), sysid & 0xFF,
            (chan16 >> 8) & 0xFF, chan16 & 0xFF, 0, 0, 0]


def p2_mac_iden_up_tdma(iden: int, base_hz: float, spacing_hz: float,
                        chan_type: int = 3) -> list[int]:
    """Identifier Update TDMA MAC message (op 0x73 → P1 0x33 parser)."""
    tsbk = iden_up_tdma_tsbk(iden, base_hz, spacing_hz,
                             chan_type=chan_type)      # 12 bytes
    return [0x73] + [int(b) for b in tsbk[2:10]]


def p2_mac_group_grant(chan16: int, tg: int, src: int,
                       svc: int = 0) -> list[int]:
    """Group Voice Channel Grant (abbreviated) MAC message (op 0x40;
    decode side p2_mac._h_grp_grant)."""
    return [0x40, svc & 0xFF, (chan16 >> 8) & 0xFF, chan16 & 0xFF,
            (tg >> 8) & 0xFF, tg & 0xFF,
            (src >> 16) & 0xFF, (src >> 8) & 0xFF, src & 0xFF]


def p2_xcch_ts(payload: np.ndarray, duid_idx: int, sf_pos: int,
               scramble: np.ndarray | None = None,
               isch_first: bool = False) -> np.ndarray:
    """One 360-bit xCCH timeslot: RS(63,35) encode, bit-geometry
    insertion, LFSR scramble at the superframe position, DUID codeword
    and ISCH word (reference p25p2_frame.c TX geometry inverted)."""
    from dsdneo_tpu.protocol.p25 import p2_xcch
    from dsdneo_tpu.protocol.p25.phase2 import DUID_CANONICAL, DUID_OFFSETS
    kind = "sacch" if len(payload) == 180 else "facch"
    parity = p2_xcch.xcch_rs_encode(payload, kind)
    ts = np.zeros(360, dtype=np.uint8)
    if kind == "sacch":
        p2_xcch.insert_sacch(ts, payload, parity)
        keep = np.zeros(360, dtype=bool)
        keep[2:74] = keep[76:184] = keep[184:244] = keep[246:318] = True
    else:
        p2_xcch.insert_facch(ts, payload, parity)
        keep = np.zeros(360, dtype=bool)
        keep[2:74] = keep[76:138] = keep[180:202] = True
        keep[202:244] = keep[246:318] = True
    if scramble is not None:
        base = 360 * sf_pos + 20
        ts = np.where(keep, ts ^ scramble[base:base + 360], ts)
    cw = DUID_CANONICAL[duid_idx]
    for k, off in enumerate(DUID_OFFSETS):
        ts[off] = (cw >> (7 - k)) & 1
    loc = {0: 0, 4: 1, 8: 2}.get(sf_pos)
    isch = (p2_xcch.isch_codeword((1 << 5) | (loc << 3))
            if (isch_first and loc is not None) else p2_xcch.ISCH_SYNC)
    for i in range(40):
        ts[320 + i] = (isch >> (39 - i)) & 1
    return ts


def p2_cc_superframes(n_superframes: int, wacn: int, sysid: int,
                      nac: int, messages_fn=None) -> np.ndarray:
    """Dibit stream of a Phase 2 TDMA CONTROL channel: every timeslot
    carries a scrambled SACCH (DUID 3) MAC PDU — MAC_IDLE headers with
    NET_STS / IDEN_UP / grant messages supplied per timeslot by
    ``messages_fn(sf, global_ts) -> list of MAC messages`` (default:
    NET_STS only).  The reference trunks such channels with
    state->p25_cc_is_tdma=1 (p25_trunk_sm.c:289)."""
    from dsdneo_tpu.protocol.p25 import p2_xcch
    from dsdneo_tpu.symbols import framesync
    scr = p2_xcch.generate_scramble_bits(wacn, sysid, nac, 12 * 360 + 380)
    sync = next(d for d in framesync.SYNC_DEFS if d.name == "+P25p2")
    sync_d = np.array([1 if c == "1" else 3 for c in sync.pattern],
                      dtype=np.uint8)
    if messages_fn is None:
        messages_fn = lambda sf, g: [p2_mac_net_sts(wacn, sysid)]
    dibs = [np.zeros(40, np.uint8)]
    for sf in range(n_superframes):
        for frame in range(3):
            dibs.append(sync_d)
            for k in range(4):
                g = 4 * frame + k
                payload = p2_mac_payload(3, messages_fn(sf, g))
                ts = p2_xcch_ts(payload, 3, g, scramble=scr,
                                isch_first=(k == 0))
                if k == 3:
                    ts = ts[:320]     # trailing ISCH IS the next sync
                dibs.append(((ts[0::2] << 1) | ts[1::2]).astype(np.uint8))
    dibs.append(np.zeros(60, np.uint8))
    return np.concatenate(dibs)


def p2_cc_iq(n_sf: int = 3, msgs=None, wacn: int = 0xBEE00,
             sysid: int = 0x14C, nac: int = 0x293,
             seed: int = 0) -> np.ndarray:
    """P25 Phase 2 LCCH superframes (:func:`p2_cc_superframes`) as
    6000 sym/s H-DQPSK-style 4FSK baseband at 48 kHz, 30 dB SNR."""
    dib = p2_cc_superframes(n_sf, wacn, sysid, nac, msgs)
    sps = 8
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dib]
    inst = np.repeat(lv, sps) * (1800.0 / 3.0)
    inst = np.convolve(inst, np.ones(sps // 2) / (sps // 2), mode="same")
    iq = np.exp(2j * np.pi * np.cumsum(inst)
                / (sps * 6000.0)).astype(np.complex64)
    rng = np.random.default_rng(seed)
    return iq + (rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape)
                 ).astype(np.complex64) * 10 ** (-30 / 20)


def p2_cc_default_msgs(center_hz: float, grant_ch: int, tg: int,
                       wacn: int, sysid: int):
    """MAC message schedule for :func:`p2_cc_iq`: IDEN_UP TDMA, a group
    voice grant and NET_STS in rotation."""
    def msgs(sf, g):
        if g % 4 == 1:
            return [p2_mac_iden_up_tdma(1, center_hz, 6250.0)]
        if g % 4 == 2:
            return [p2_mac_group_grant(grant_ch, tg, 5555)]
        return [p2_mac_net_sts(wacn, sysid)]
    return msgs
