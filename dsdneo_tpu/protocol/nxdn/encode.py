"""NXDN control-channel SYNTHESIS: spec-built RCCH CAC frames as
complex baseband, for tests and benches (the off-air captures carry no
RCCH)."""

from __future__ import annotations

import numpy as np

from dsdneo_tpu.fec import conv
from dsdneo_tpu.protocol.nxdn.decoder import (_PERM_12_25,
                                              _pn9_scramble_positions,
                                              crc16_cac)
from dsdneo_tpu.symbols.framesync import SYNC_DEFS


def cac_stream_iq(n_frames: int = 1, seed: int = 3) -> np.ndarray:
    """Spec-built NXDN RCCH stream: n_frames CAC frames at the 192-
    dibit stride, each a CRC16-CAC-valid message through K=5 conv
    encode + 12:14 puncture + PERM_12_25 interleave + PN scramble,
    LICH 0x01.  Returns complex baseband at 48 kHz."""
    rng = np.random.default_rng(seed)
    fsw = next(d for d in SYNC_DEFS if d.name == "+NXDN FSW")
    fsw_d = np.array([int(c) for c in fsw.pattern], dtype=np.uint8)
    scram = np.zeros(182, dtype=np.uint8)
    scram[_pn9_scramble_positions()] = 1

    def close_crc(bits171):
        base = bits171.copy()
        base[155:] = 0
        r0 = crc16_cac(base)
        A = np.zeros((16, 16), dtype=np.uint8)
        for i in range(16):
            e = base.copy()
            e[155 + i] = 1
            ri = crc16_cac(e) ^ r0
            A[:, i] = [(ri >> (15 - j)) & 1 for j in range(16)]
        b = np.array([(r0 >> (15 - j)) & 1 for j in range(16)], np.uint8)
        M = np.concatenate([A, b[:, None]], axis=1)
        for col in range(16):
            piv = next(r for r in range(col, 16) if M[r, col])
            M[[col, piv]] = M[[piv, col]]
            for r in range(16):
                if r != col and M[r, col]:
                    M[r] ^= M[col]
        bits171[155:] = M[:, 16]
        assert crc16_cac(bits171) == 0
        return bits171

    mapping = [0, 1, 2, None, 3, 4, 5, 6, 7, 8, 9, None, 10, 11]
    lich_full = 0x01 << 1
    parity = 0
    for k in range(7, 3, -1):
        parity ^= (lich_full >> k) & 1
    lich_full |= parity

    frames = []
    for _f in range(n_frames):
        bits171 = np.zeros(171, dtype=np.uint8)
        bits171[2:8] = [(5 >> (5 - i)) & 1 for i in range(6)]
        bits171[8:155] = rng.integers(0, 2, 147).astype(np.uint8)
        close_crc(bits171)
        enc = conv.encode(bits171)
        deperm = np.zeros(300, dtype=np.uint8)
        for g in range(25):
            for i, m in enumerate(mapping):
                if m is not None:
                    deperm[g * 12 + m] = enc[g * 14 + i]
        bits300 = deperm[_PERM_12_25]
        payload = np.zeros(182, dtype=np.uint8)
        for i in range(8):
            payload[i] = ((lich_full >> (7 - i)) & 1) << 1
        payload[8:158] = ((bits300[0::2] << 1) | bits300[1::2]
                          ).astype(np.uint8)
        payload ^= scram * 2
        frames.append(np.concatenate([fsw_d, payload]))
    dib = np.concatenate([rng.integers(0, 4, 100).astype(np.uint8)]
                         + frames
                         + [rng.integers(0, 4, 500).astype(np.uint8)])
    sps = 20
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dib] / 3.0
    inst = np.repeat(lv, sps)
    t = np.arange(-sps // 2, sps // 2 + 1)
    g = np.exp(-0.5 * (t / (sps / 4.0)) ** 2)
    inst = np.convolve(inst, g / g.sum(), mode="same") * (1050.0 / 24000.0)
    phase = np.pi * np.cumsum(inst)
    return np.exp(1j * phase).astype(np.complex64)
