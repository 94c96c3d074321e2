"""Batched P25 Phase 2 TDMA voice: [C, B] I/Q → per-slot PCM on device.

The P25p2 counterpart of engine.voicebatch/dmrbatch (BASELINE.md names
"P25p2 trunk-follow" among the configs; reference frame walk
src/protocol/p25/phase2/p25p2_frame.c:1757):

  1. fused front end at 6000 sym/s + frame-sync correlation on device;
     per top-K candidate the blob also carries each of the 4 timeslots'
     DUID dibits and raw ISCH field, so the host can type bursts and
     track the superframe position without touching the dibit stream;
  2. host frame walk: DUID nearest-codeword typing + ISCH superframe
     tracking (phase2.P25P2Decoder.handle semantics) selects the 4V/2V
     voice timeslots and assigns each AMBE frame its descrambling row
     and (channel, slot) output stream;
  3. optional ESS staging: with a keyring, a small device gather
     fetches the ESS_B fragments/ESS_A parity, the host runs the
     RS(63,35) ESS decode (phase2._process_ess) and generates the
     per-frame RC4 keystream bytes (reference mbe_dequantize ADP path);
  4. one device dispatch: voice-frame gather → LFSR descramble (XOR
     against the device-resident scramble table) → batched AMBE ECC →
     RC4 keystream application → dequantization → scatter by
     (channel·2+slot, frame order) → batched harmonic synthesis.

A sustained 2-slot voice stream generator (``synth_p2_voice_stream``)
provides the bench source and the ground truth for the ECC/descramble
roundtrip test: the reference ships only a P25p2 control-channel
fixture, no voice capture.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

FRAME_DIBITS = 720            # 20-dibit sync + 4 × 180-dibit timeslots
TS_DIBITS = 180
MAX_L = 56
# voice-frame bit offsets inside a descrambled timeslot
VOICE_BIT_OFFS = (2, 76, 172, 246)
# DUID codeword dibits inside a timeslot (bit pairs 0/1, 74/75,
# 244/245, 318/319 → dibits 0, 37, 122, 159)
DUID_DIBITS = np.array([0, 37, 122, 159], dtype=np.int32)
ISCH_DIBIT0 = 160             # bits 320:360 → dibits 160..180


def synth_p2_voice_stream(n_superframes: int = 8, seed: int = 0,
                          wacn: int = 0xBEE00, sysid: int = 0x14C,
                          nac: int = 0x140, sps: int = 8,
                          alg: int = 0, kid: int = 0, key: int = 0,
                          mi: int = 0):
    """Dense 2-slot P25p2 voice stream: every superframe carries the
    12-timeslot TDMA cadence with both slots running the 4V×4 + 2V
    voice pattern (18 AMBE frames per slot per superframe), correct
    ISCH location words, DUID codewords, ESS fields, and the WACN/SYS/
    NAC LFSR scramble.  With ``alg=0xAA`` the AMBE parameter bits are
    RC4-encrypted exactly as the reference applies the ADP keystream.

    Returns (complex baseband at sps·6000 Hz, dibits, bits49
    [2, n_superframes·18, 49] ground-truth parameter bits per slot).
    """
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    from dsdneo_tpu.protocol.p25 import p2_xcch
    from dsdneo_tpu.protocol.p25.phase2 import (DUID_CANONICAL,
                                                DUID_OFFSETS)
    from dsdneo_tpu.symbols import framesync
    rng = np.random.default_rng(seed)
    scr = p2_xcch.generate_scramble_bits(wacn, sysid, nac, 12 * 360 + 380)
    sync = next(d for d in framesync.SYNC_DEFS if d.name == "+P25p2")
    sync_d = np.array([1 if c == "1" else 3 for c in sync.pattern],
                      dtype=np.uint8)

    bits49 = np.zeros((2, n_superframes * 18, 49), dtype=np.uint8)
    nvoice = {0: 0, 1: 0}
    # per-slot ESS payload: ALG ‖ KID ‖ MI ‖ reserved (96 bits)
    ess_payload = np.zeros(96, dtype=np.uint8)
    for i in range(8):
        ess_payload[i] = (alg >> (7 - i)) & 1
    for i in range(16):
        ess_payload[8 + i] = (kid >> (15 - i)) & 1
    for i in range(64):
        ess_payload[24 + i] = (mi >> (63 - i)) & 1
    # RS(63,35) systematic parity over the padded hexbit vector
    from dsdneo_tpu.fec import rs
    vec = np.zeros(63, dtype=np.int64)
    vec[19:35] = p2_xcch._hexpack(ess_payload)
    enc = rs.rs_63_35().encode(vec[:35])
    parity_hex = enc[35:63]
    ess_parity = np.zeros(168, dtype=np.uint8)
    for i in range(28):
        for j in range(6):
            ess_parity[6 * i + j] = (int(parity_hex[i]) >> (5 - j)) & 1

    ks_all = None
    if alg == 0xAA and key:
        from dsdneo_tpu.crypto.keystream import rc4_keystream
        rckey = (key & 0xFFFFFFFFFF).to_bytes(5, "big") \
            + (mi & (1 << 64) - 1).to_bytes(8, "big")
        # one superframe per slot needs 18 frames × 7 bytes from drop 256
        ks_all = rc4_keystream(rckey, 18 * 7, drop=256)

    dibs = [np.zeros(40, np.uint8)]          # lead-in
    for sf in range(n_superframes):
        fourv = {0: 0, 1: 0}
        for frame in range(3):               # 3 frames per superframe
            dibs.append(sync_d)
            loc = frame
            for k in range(4):
                g = 4 * frame + k            # global TS index 0..11
                slot = g % 2
                j = g // 2                   # slot-local burst index 0..5
                ts = np.zeros(360, dtype=np.uint8)
                if j < 5:                    # 4V×4 then 2V
                    n_fr = 4 if j < 4 else 2
                    duid_cw = DUID_CANONICAL[0 if j < 4 else 6]
                    for f in range(n_fr):
                        b = rng.integers(0, 2, 49).astype(np.uint8)
                        fi = nvoice[slot]
                        bits49[slot, fi] = b
                        tx = b.copy()
                        if ks_all is not None:
                            fr_in_sf = fi % 18
                            ks = ks_all[7 * fr_in_sf:7 * fr_in_sf + 7]
                            by = np.packbits(tx)
                            by = by ^ ks
                            tx = np.unpackbits(by)[:49]
                        nvoice[slot] += 1
                        off = VOICE_BIT_OFFS[f]
                        ts[off:off + 72] = encode_ambe_ecc(tx)
                    if j < 4:                # ESS_B fragment
                        c4 = fourv[slot]
                        ts[148:172] = ess_payload[24 * c4:24 * (c4 + 1)]
                        fourv[slot] = c4 + 1
                    else:                    # 2V: ESS_A parity fields
                        ts[148:244] = ess_parity[:96]
                        ts[246:318] = ess_parity[96:]
                        fourv[slot] = 0
                    # scramble voice + ESS field regions
                    mask = scr[360 * g + 20:360 * g + 380]
                    keep = np.zeros(360, dtype=bool)
                    for f in range(n_fr):
                        off = VOICE_BIT_OFFS[f]
                        keep[off:off + 72] = True
                    keep[148:244] = True
                    keep[246:318] = True
                    ts = np.where(keep, ts ^ mask, ts)
                else:
                    duid_cw = DUID_CANONICAL[13]   # unscrambled LCCH
                    ts[:320] = rng.integers(0, 2, 320)
                for b_i, off in enumerate(DUID_OFFSETS):
                    ts[off] = (duid_cw >> (7 - b_i)) & 1
                if k == 0:
                    isch = p2_xcch.isch_codeword((1 << 5) | (loc << 3))
                else:
                    isch = p2_xcch.ISCH_SYNC
                for i in range(40):
                    ts[320 + i] = (isch >> (39 - i)) & 1
                if k == 3:
                    # the 4th burst is 320 bits: its trailing ISCH slot
                    # IS the next frame sync (the +P25p2 sync pattern is
                    # the dibit form of ISCH_SYNC)
                    ts = ts[:320]
                dibs.append(((ts[0::2] << 1) | ts[1::2]).astype(np.uint8))
    dibs.append(np.zeros(60, np.uint8))
    dib = np.concatenate(dibs)

    # C4FM-style pulse shaping (half-symbol moving average, ±1800 Hz
    # deviation — the tests' synth_c4fm waveform the demod is tuned for)
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dib]
    inst = np.repeat(lv, sps) * (1800.0 / 3.0)
    k = max(sps // 2, 1)
    inst = np.convolve(inst, np.ones(k) / k, mode="same")
    phase = 2 * np.pi * np.cumsum(inst) / (sps * 6000.0)
    return np.exp(1j * phase).astype(np.complex64), dib, bits49


@partial(jax.jit, static_argnames=("C2", "n_steps", "pcm_fmt"))
def p2_voice_decode_gather(dibits, scr_tab, f_ch, f_tpos, f_row, f_offidx,
                           f_out, f_ord, ks_bytes, C2: int, n_steps: int,
                           pcm_fmt: str = "f16", state=None):
    """Device program: voice-frame gather → LFSR descramble → AMBE ECC
    → RC4 keystream XOR → dequant → scatter by (out stream, order) →
    repeat gate → synthesis.  Pad frames use f_out == C2.  ``scr_tab``
    is the [12·360+380] scramble bit table for the channel's
    WACN/SYS/NAC; ``ks_bytes`` [F, 7] is the per-frame RC4 keystream
    (zeros = clear); ``state`` is the (synthesis, frame-repeat) carry
    from the previous block.  Returns (wire, state)."""
    from dsdneo_tpu.fec.device import ambe_ecc_batch
    from dsdneo_tpu.vocoder.device import (ambe_params_gated,
                                           scatter_repeat_synth,
                                           voice_state_init)

    Tn = dibits.shape[1]
    off_d = jnp.asarray([o // 2 for o in VOICE_BIT_OFFS], jnp.int32)
    base = f_tpos + off_d[f_offidx]                       # [F] dibit base
    gp = jnp.clip(base[:, None] + jnp.arange(36), 0, Tn - 1)
    ch = jnp.minimum(f_ch, dibits.shape[0] - 1)
    dd = dibits[ch[:, None], gp]                          # [F, 36]
    bits72 = jnp.zeros((dd.shape[0], 72), dtype=jnp.uint8)
    bits72 = bits72.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits72 = bits72.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    off_b = jnp.asarray(VOICE_BIT_OFFS, jnp.int32)
    sidx = (360 * f_row + 20 + off_b[f_offidx])[:, None] + jnp.arange(72)
    bits72 = bits72 ^ scr_tab[jnp.clip(sidx, 0, scr_tab.shape[0] - 1)]

    bits49, _errs = ambe_ecc_batch(bits72)
    # keystream application: unpack [F, 7] bytes → 56 bits, XOR low 49
    ksb = ((ks_bytes[:, :, None] >> jnp.arange(7, -1, -1)) & 1
           ).reshape(ks_bytes.shape[0], 56).astype(jnp.uint8)
    bits49 = bits49 ^ ksb[:, :49]
    w0, voiced, amps, good = ambe_params_gated(bits49, _errs)
    if state is None:
        state = voice_state_init(C2)
    return scatter_repeat_synth(w0, voiced, amps, good, f_out, f_ord,
                                C2, n_steps, state, pcm_fmt)


class BatchedP2VoicePipeline(VoiceCarryMixin):
    """Drives the batched P25p2 2-slot TDMA voice chain over [C, B]
    blocks.  All channels share one WACN/SYS/NAC scramble (the fleet
    case: many voice channels of ONE trunked system; per-system
    sub-fleets run separate pipeline instances)."""

    SYNC_NAMES = ("+P25p2",)
    SYNC_TOPK = 64                # ~8.3 frames/s + shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 wacn: int = 0xBEE00, sysid: int = 0x14C, nac: int = 0x140,
                 sync_threshold: float = 0.62, keyring=None,
                 pcm_fmt: str = "f16"):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        from dsdneo_tpu.protocol.p25 import p2_xcch
        self.C = C
        self.fs = fs
        self.mode = MODES["p25p2"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.keyring = keyring
        self.pcm_fmt = pcm_fmt
        self.params = (wacn, sysid, nac)
        self._scr = p2_xcch.generate_scramble_bits(wacn, sysid, nac,
                                                   12 * 360 + 380)
        self._scr_dev = None
        self._jits = {}
        # per-(channel, slot) crypto state across blocks
        self.crypto = [{"alg": 0, "kid": 0, "mi": 0, "staged": None}
                       for _ in range(2 * C)]

    def frontend_sync_device(self, iq):
        """Fused front end + frame-sync correlation; per candidate the
        blob carries the 4 timeslots' DUID dibits and raw ISCH dibits
        so the host can walk frames without the dibit stream."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("p2", B, n_sym)
        fn = self._jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(names)
            n_pat = len(defs[0].pattern)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            # per-TS gather offsets relative to sync START
            duid_offs = (n_pat + TS_DIBITS * np.arange(4)[:, None]
                         + DUID_DIBITS[None]).astype(np.int32)   # [4, 4]
            isch_offs = (n_pat + TS_DIBITS * np.arange(4)[:, None]
                         + ISCH_DIBIT0
                         + np.arange(20)[None]).astype(np.int32)  # [4, 20]

            @jax.jit
            def fn(x):
                dibits, soft, _power = frontend_step(
                    x, taps, self.sps, n_sym, self.mode.four_level)
                sc = correlate_syncs_device(soft, names)
                bs = jnp.max(sc, axis=1)
                vals, idx = jax.lax.top_k(bs, k_cand)
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                Cn = dibits.shape[0]
                Tn = dibits.shape[1]
                rows = jnp.arange(Cn)[:, None, None, None]
                gp_d = jnp.clip(idx[:, :, None, None]
                                + jnp.asarray(duid_offs)[None, None],
                                0, Tn - 1)
                dq4 = dibits[rows, gp_d]                  # [C, K, 4, 4]
                duid_oct = ((dq4[..., 0] << 6) | (dq4[..., 1] << 4)
                            | (dq4[..., 2] << 2) | dq4[..., 3]
                            ).astype(jnp.uint8)           # [C, K, 4]
                gp_i = jnp.clip(idx[:, :, None, None]
                                + jnp.asarray(isch_offs)[None, None],
                                0, Tn - 1)
                di = dibits[rows, gp_i]                   # [C, K, 4, 20]
                isch5 = ((di[..., 0::4] << 6) | (di[..., 1::4] << 4)
                         | (di[..., 2::4] << 2) | di[..., 3::4]
                         ).astype(jnp.uint8)              # [C, K, 4, 5]
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                blob = jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq,
                     duid_oct.reshape(Cn, -1),
                     isch5.reshape(Cn, -1)], axis=1)
                return dibits, blob
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return self.frontend_finish((dibits_dev, blob_dev, n_sym))

    def frontend_dispatch(self, iq):
        """Queue the frontend program WITHOUT fetching the blob (deep
        pipelining, see voicebatch.frontend_dispatch)."""
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("p2", B, n_sym)
        fn = self._jits.get(key)
        if fn is None:
            self.frontend_sync_device(iq)   # compile once
            fn = self._jits[key]
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return dibits_dev, blob_dev, n_sym

    def frontend_finish(self, fe, cofetch=None):
        dibits_dev, blob_dev, n_sym = fe
        if cofetch is not None:
            # one device-to-host exchange for the candidate blob + the
            # caller's extra device arrays (see TrunkedFleet.step)
            import jax
            blob, _co = jax.device_get((blob_dev, cofetch))
        else:
            blob, _co = np.asarray(blob_dev), None
        defs, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        k_cand = min(self.SYNC_TOPK, n_sym - n_max + 1)
        o = 0
        idx = blob[:, o:o + 2 * k_cand].copy().view(np.uint16
                                                    ).astype(np.int64)
        o += 2 * k_cand
        vq = blob[:, o:o + k_cand]; o += k_cand
        duid = blob[:, o:o + 4 * k_cand].reshape(-1, k_cand, 4)
        o += 4 * k_cand
        isch = blob[:, o:o + 20 * k_cand].reshape(-1, k_cand, 4, 5)
        out = (dibits_dev, idx, vq, duid, isch, n_sym)
        return (out, _co) if cofetch is not None else out

    @staticmethod
    def _isch_word(b5: np.ndarray) -> int:
        """5 packed-dibit bytes → the 40-bit ISCH word."""
        v = 0
        for by in b5:
            v = (v << 8) | int(by)
        return v

    @staticmethod
    @lru_cache(maxsize=1)
    def _isch_arrays() -> tuple:
        """Sorted (keys, values) arrays of the ISCH codeword table for
        vectorized lookup (walk_frames hot path at C=320)."""
        from dsdneo_tpu.protocol.p25 import p2_xcch
        t = p2_xcch._isch_table()
        keys = np.asarray(sorted(t), dtype=np.int64)
        vals = np.asarray([t[k] for k in sorted(t)], dtype=np.int64)
        return keys, vals

    @staticmethod
    @lru_cache(maxsize=1)
    def _duid_lut() -> np.ndarray:
        """[256] received-octet → DUID (or -1) lookup: the nearest-
        codeword decode is a pure function of the 8-bit received word,
        so the fleet walk replaces per-hit popcount loops with one
        table index (host-walk hot path at C=320)."""
        from dsdneo_tpu.protocol.p25.phase2 import duid_lookup
        return np.asarray([duid_lookup(v) for v in range(256)],
                          dtype=np.int8)

    def _resolve_isch_batch(self, vq, isch):
        """Whole-batch ISCH resolution BEFORE any channel loop: assemble
        every candidate's 40-bit words and resolve them through one
        sorted-table searchsorted pass; only novel words fall back to
        the memoized nearest-codeword search.  Returns ``(oka [C, K]
        score gate, sf_start_all [C, K, 4] superframe start position or
        -1)`` — shared by the voice walk and the control-channel walk
        (host hot path at C=320)."""
        from dsdneo_tpu.protocol.p25 import p2_xcch
        iba = isch.astype(np.int64)                      # [C, K, 4, 5]
        words_all = ((iba[..., 0] << 32) | (iba[..., 1] << 24)
                     | (iba[..., 2] << 16) | (iba[..., 3] << 8)
                     | iba[..., 4])                      # [C, K, 4]
        keys_s, vals_s = self._isch_arrays()
        wf = words_all.ravel()
        ji = np.clip(np.searchsorted(keys_s, wf), 0, len(keys_s) - 1)
        hitk = keys_s[ji] == wf
        vres = np.where(hitk, vals_s[ji], -1).astype(np.int64)
        sca = vq.astype(np.float32) / 127.0
        oka = sca >= self.threshold
        if not hitk.all():
            memo = getattr(self, "_isch_memo", None)
            if memo is None:
                memo = self._isch_memo = {}
            # only resolve misses on candidates that pass the score
            # threshold (the rest are never walked)
            need = (~hitk) & np.repeat(oka.ravel(), 4)
            for k in np.flatnonzero(need):
                word = int(wf[k])
                v = memo.get(word)
                if v is None:
                    v = p2_xcch.isch_lookup(word)
                    memo[word] = v
                vres[k] = v
        is_sync = wf == p2_xcch.ISCH_SYNC
        sfv = (vres >> 3) & 3
        valid = ((~is_sync) & (vres >= 0) & (((vres >> 5) & 3) == 1)
                 & (sfv <= 2))
        sf_start_all = np.where(valid, sfv * 4,
                                -1).reshape(words_all.shape)  # [C, K, 4]
        return oka, sf_start_all

    def walk_frames(self, idx, vq, duid, isch, n_sym: int):
        """Host frame walk (phase2.handle semantics): threshold + frame
        extent, DUID typing, ISCH superframe tracking → the per-frame
        device upload lists.  Returns (frame arrays, ess_jobs) where
        ess_jobs describe the ESS field positions per voice timeslot
        for the optional crypto path."""
        from dsdneo_tpu.protocol.p25 import p2_xcch
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        n_pat = len(defs[0].pattern)
        duid_lut = self._duid_lut()
        isch_tab = p2_xcch._isch_table()
        f_ch, f_tpos, f_row, f_offidx, f_out, f_ord = ([] for _ in range(6))
        ess_jobs = []           # (c, ts_pos, row, slot, kind, frag_idx)
        oka, sf_start_all = self._resolve_isch_batch(vq, isch)
        for c in range(idx.shape[0]):
            ok = oka[c]
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            # vectorized field decode: DUID through the 256-entry LUT
            duids_v = duid_lut[duid[c][ok][order]]       # [W, 4] int8
            sf_start = sf_start_all[c][ok][order].tolist()
            # greedy frame acceptance (small python loop over ~25 hits)
            # + per-TS ISCH/superframe tracking; the per-FRAME array
            # emission below is fully vectorized — at fleet scale the
            # old per-frame append loop dominated the host step
            pos_l = positions.tolist()
            acc_w = []
            last = -10 ** 9
            for w, t in enumerate(pos_l):
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    continue
                last = t
                acc_w.append(w)
            if not acc_w:
                continue
            A = len(acc_w)
            rows_l = []
            sf_pos = None
            for w in acc_w:
                row_s = sf_start[w]
                rrow = []
                for ts in range(4):
                    s = row_s[ts]
                    if s >= 0:
                        sf_pos = s
                    rrow.append(sf_pos if sf_pos is not None else 0)
                    if sf_pos is not None:
                        sf_pos = (sf_pos + 1) % 12
                rows_l.append(rrow)
            rows = np.asarray(rows_l, np.int32)
            aw = np.asarray(acc_w)
            d4 = duids_v[aw]                             # [A, 4]
            tpos4 = (positions[aw][:, None].astype(np.int64)
                     + n_pat + TS_DIBITS * np.arange(4))  # [A, 4]
            voice = (d4 == 0) | (d4 == 6)
            nf4 = np.where(d4 == 0, 4, np.where(d4 == 6, 2, 0))
            # flatten accepted voice TS in (frame, ts) walk order
            sel = np.nonzero(voice)                      # row-major ✓
            nf = nf4[sel]                                # [V]
            V = nf.size
            if V == 0:
                continue
            ts_sel = sel[1]
            slot_sel = (ts_sel % 2).astype(np.int32)
            rep = np.repeat(np.arange(V), nf)            # frame→TS index
            f_ch.append(np.full(rep.size, c, np.int32))
            f_tpos.append(tpos4[sel][rep].astype(np.int32))
            f_row.append(rows[sel][rep].astype(np.int32))
            # per-TS frame index 0..nf-1
            starts = np.concatenate([[0], np.cumsum(nf)[:-1]])
            f_offidx.append((np.arange(rep.size)
                             - starts[rep]).astype(np.int32))
            f_out.append((2 * c + slot_sel[rep]).astype(np.int32))
            # per-slot running frame order
            ords = np.zeros(rep.size, np.int64)
            for s in (0, 1):
                m = slot_sel[rep] == s
                ords[m] = np.arange(int(m.sum()))
            f_ord.append(ords.astype(np.int32))
            if self.keyring is not None:
                # ESS job list (crypto path only): small loop over the
                # accepted voice timeslots
                fourv = {0: 0, 1: 0}
                for vi in range(V):
                    s = int(slot_sel[vi])
                    if nf[vi] == 4:
                        ess_jobs.append((c, int(tpos4[sel][vi]),
                                         int(rows[sel][vi]), s, "4v",
                                         fourv[s]))
                        fourv[s] = (fourv[s] + 1) % 4
                    else:
                        ess_jobs.append((c, int(tpos4[sel][vi]),
                                         int(rows[sel][vi]), s, "2v", 0))
                        fourv[s] = 0
        if f_ch:
            arrs = tuple(np.concatenate(a) for a in
                         (f_ch, f_tpos, f_row, f_offidx, f_out, f_ord))
        else:
            arrs = tuple(np.zeros(0, np.int32) for _ in range(6))
        return arrs, ess_jobs

    def _ess_keystreams(self, dibits_dev, ess_jobs, F: int,
                        f_out, f_ord) -> np.ndarray:
        """Crypto path: gather the ESS fields of every voice timeslot,
        run the host RS(63,35) ESS decode per (channel, slot) stream in
        time order, stage ALG/KID/MI, and emit per-frame RC4 keystream
        bytes (reference p25p2_ess_decode + mbe ADP application).
        Returns [F, 7] uint8 (zeros where clear/no key)."""
        ks = np.zeros((F, 7), dtype=np.uint8)
        if self.keyring is None or not ess_jobs:
            return ks
        from dsdneo_tpu.crypto.keystream import rc4_keystream
        from dsdneo_tpu.fec import rs
        from dsdneo_tpu.protocol.p25 import p2_xcch
        # gather bits 148:318 (dibits 74..159) of each voice TS
        jc = np.asarray([j[0] for j in ess_jobs], np.int32)
        jt = np.asarray([j[1] for j in ess_jobs], np.int32)
        H = jc.shape[0]
        Hp = -(-H // 32) * 32
        jcp = np.zeros(Hp, np.int32)
        jcp[:H] = jc
        jtp = np.zeros(Hp, np.int32)
        jtp[:H] = jt

        if "essgather" not in self._jits:
            @jax.jit
            def _gather(dd, chv, posv):
                gp = jnp.clip(posv[:, None] + 74 + jnp.arange(86),
                              0, dd.shape[1] - 1)
                ch = jnp.minimum(chv, dd.shape[0] - 1)
                return dd[ch[:, None], gp]
            self._jits["essgather"] = _gather
        raw = np.asarray(self._jits["essgather"](
            dibits_dev, jnp.asarray(jcp), jnp.asarray(jtp)))[:H]
        bits = np.zeros((H, 172), dtype=np.uint8)
        bits[:, 0::2] = (raw >> 1) & 1
        bits[:, 1::2] = raw & 1

        # descramble every job's 172 ESS bits in one vectorized XOR
        # (the scrambler row offset is per-job)
        offs = np.asarray([360 * row + 168
                           for (_c, _tp, row, _s, _k, _f) in ess_jobs],
                          dtype=np.int64)
        xs = bits ^ self._scr[offs[:, None] + np.arange(172)]

        # pass 1: accumulate ESS_B fragments in walk order and build
        # every 2V job's RS(63,35) vector; a batched device syndrome
        # screen (fec.device.rs_syndromes_batch) then lets the common
        # clean case skip the host Berlekamp-Massey entirely
        ess_b = {}
        vecs = {}
        for h, (c, ts_pos, row, slot, kind, frag) in enumerate(ess_jobs):
            key = 2 * c + slot
            x = xs[h]
            if kind == "4v":
                ess_b.setdefault(key, np.zeros(96, np.uint8))
                ess_b[key][24 * frag:24 * (frag + 1)] = x[:24]
            else:
                parity = np.concatenate([x[0:96], x[98:170]])
                vec = np.zeros(63, dtype=np.int64)
                vec[19:35] = p2_xcch._hexpack(
                    ess_b.get(key, np.zeros(96, np.uint8)))
                vec[35:63] = p2_xcch._hexpack(parity)
                vecs[h] = vec
        clean = {}
        if vecs:
            from dsdneo_tpu.fec.device import rs_syndromes_batch
            hs = sorted(vecs)
            syn = rs_syndromes_batch(
                np.stack([vecs[h] for h in hs]), nroots=28, fcr=1)
            for h, s in zip(hs, syn):
                clean[h] = not s.any()

        # pass 2: crypto state machine + per-frame keystreams (reads
        # only pass 1's vecs/clean — the fragment accumulation is done)
        frame_at = {}
        for h, (c, ts_pos, row, slot, kind, frag) in enumerate(ess_jobs):
            key = 2 * c + slot
            cs = self.crypto[key]
            if kind == "4v":
                nf = 4
            else:
                vec = vecs[h]
                if clean.get(h):
                    dec, nerr = vec, 0        # screened clean on device
                else:
                    dec, nerr = rs.rs_63_35().decode(vec, erasures=[])
                if 0 <= nerr < 15:
                    eb = np.zeros(96, dtype=np.uint8)
                    for i in range(16):
                        for j in range(6):
                            eb[6 * i + j] = (int(dec[19 + i]) >> (5 - j)) & 1
                    alg = int(eb[:8] @ (1 << np.arange(7, -1, -1)))
                    kid = int(eb[8:24] @ (1 << np.arange(15, -1, -1)))
                    mi64 = 0
                    for b in eb[24:88]:
                        mi64 = (mi64 << 1) | int(b)
                    cs["staged"] = (alg, kid, mi64)
                if cs["staged"] is not None:
                    cs["alg"], cs["kid"], cs["mi"] = cs["staged"]
                    cs["staged"] = None
                nf = 2
            # keystream for this timeslot's frames
            if cs["alg"] == 0xAA and cs["mi"]:
                k = self.keyring.lookup(cs["kid"]) \
                    if self.keyring is not None else None
                if k is not None:
                    base = frame_at.get(key, 0)
                    rckey = (int(k) & 0xFFFFFFFFFF).to_bytes(5, "big") \
                        + (cs["mi"] & (1 << 64) - 1).to_bytes(8, "big")
                    kbytes = rc4_keystream(rckey, 7 * nf,
                                           drop=256 + 7 * (base % 18))
                    sel = np.flatnonzero(
                        (f_out == key)
                        & (f_ord >= base) & (f_ord < base + nf))
                    for m, fi in enumerate(sel):
                        ks[fi] = kbytes[7 * m:7 * (m + 1)]
            frame_at[key] = frame_at.get(key, 0) + nf
        return ks

    def decode_block_async(self, iq):
        """Dispatch one [C, B] block; returns the device PCM handle
        ([C·2, n_steps·160] per-slot streams)."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe6):
        dibits_dev, idx, vq, duid, isch, n_sym = fe6
        arrs, ess_jobs = self.walk_frames(idx, vq, duid, isch, n_sym)
        f_ch, f_tpos, f_row, f_offidx, f_out, f_ord = arrs
        F = f_ch.shape[0]
        if F == 0:
            return None
        ks = self._ess_keystreams(dibits_dev, ess_jobs, F, f_out, f_ord)
        n_steps = int(f_ord.max()) + 1
        Fp = -(-F // 64) * 64
        Tp = -(-n_steps // 36) * 36
        C2 = 2 * self.C

        def pad(a, fill=0):
            out = np.full(Fp, fill, dtype=a.dtype)
            out[:F] = a
            return jnp.asarray(out)

        ksp = np.zeros((Fp, 7), dtype=np.uint8)
        ksp[:F] = ks
        if self._scr_dev is None:
            self._scr_dev = jnp.asarray(self._scr.astype(np.uint8))
        wire, self._vstate = p2_voice_decode_gather(
            dibits_dev, self._scr_dev, pad(f_ch), pad(f_tpos),
            pad(f_row), pad(f_offidx),
            pad(f_out, fill=C2), pad(f_ord), jnp.asarray(ksp),
            C2, Tp, pcm_fmt=self.pcm_fmt,
            state=getattr(self, "_vstate", None))
        return wire

    def fetch_pcm(self, handle) -> np.ndarray:
        if handle is None:
            return np.zeros((2 * self.C, 0), dtype=np.float32)
        from dsdneo_tpu.ops.audio_wire import wire_expand
        return wire_expand(np.asarray(handle), self.pcm_fmt, 2 * self.C)

    def decode_block(self, iq) -> np.ndarray:
        return self.fetch_pcm(self.decode_block_async(iq))

    def decode_block_bits49(self, iq):
        """Test/parity hook: run the chain up to the AMBE parameter
        bits and return ([F, 49] bits in dispatch order, f_out, f_ord)
        — compares against synth_p2_voice_stream's ground truth."""
        dibits_dev, idx, vq, duid, isch, n_sym = \
            self.frontend_sync_device(iq)
        arrs, ess_jobs = self.walk_frames(idx, vq, duid, isch, n_sym)
        f_ch, f_tpos, f_row, f_offidx, f_out, f_ord = arrs
        F = f_ch.shape[0]
        if F == 0:
            return (np.zeros((0, 49), np.uint8), f_out, f_ord)
        ks = self._ess_keystreams(dibits_dev, ess_jobs, F, f_out, f_ord)

        from dsdneo_tpu.fec.device import ambe_ecc_batch
        if self._scr_dev is None:
            self._scr_dev = jnp.asarray(self._scr.astype(np.uint8))

        @jax.jit
        def _bits(dd, scr_tab, chv, tposv, rowv, offv):
            Tn = dd.shape[1]
            off_d = jnp.asarray([o // 2 for o in VOICE_BIT_OFFS], jnp.int32)
            base = tposv + off_d[offv]
            gp = jnp.clip(base[:, None] + jnp.arange(36), 0, Tn - 1)
            ch = jnp.minimum(chv, dd.shape[0] - 1)
            d2 = dd[ch[:, None], gp]
            b72 = jnp.zeros((d2.shape[0], 72), dtype=jnp.uint8)
            b72 = b72.at[:, 0::2].set(((d2 >> 1) & 1).astype(jnp.uint8))
            b72 = b72.at[:, 1::2].set((d2 & 1).astype(jnp.uint8))
            off_b = jnp.asarray(VOICE_BIT_OFFS, jnp.int32)
            sidx = (360 * rowv + 20 + off_b[offv])[:, None] + jnp.arange(72)
            b72 = b72 ^ scr_tab[jnp.clip(sidx, 0, scr_tab.shape[0] - 1)]
            b49, _e = ambe_ecc_batch(b72)
            return b49
        out = np.asarray(_bits(dibits_dev, self._scr_dev,
                               jnp.asarray(f_ch), jnp.asarray(f_tpos),
                               jnp.asarray(f_row), jnp.asarray(f_offidx)))
        ksb = np.unpackbits(ks, axis=1)[:, :49]
        return out ^ ksb, f_out, f_ord
