"""Batched DMR BS voice: [C, B] I/Q blocks → PCM, device-resident.

The DMR counterpart of engine.voicebatch (BASELINE.json names "DMR BS
2-slot TDMA voice" among the configs to exercise, and the north star
counts concurrent "P25/DMR channels"): one fused front-end + sync
dispatch keeps the dibits on device; the host picks voice-superframe
sync positions from the compact candidate blob and uploads them; the
18-frame-per-superframe gather (6 bursts at the 288-dibit same-slot
period × 3 AMBE frames, reference dmr_bs.c geometry as rebuilt in
protocol/dmr/bs.py), Golay/PN AMBE ECC, dequantization, and harmonic
synthesis run as one device dispatch.

Both TDMA slots decode: each slot's VC1 burst carries a real voice sync
(the following five carry EMB), so every accepted hit is one
superframe; a channel's PCM concatenates its superframes in stream
order.  AMBE has no inter-frame amplitude prediction (unlike IMBE), so
the decode is stateless across blocks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

SF_PERIOD = 288                 # same-slot burst period in dibits
SF_EXTENT = SF_PERIOD * 5 + 78  # dibits past the sync start
MAX_L = 56


def _sf_frame_offsets() -> np.ndarray:
    """[18, 36] dibit offsets of every AMBE frame in a 6-burst voice
    superframe, relative to the VC1 sync start (protocol/dmr/bs.py
    _voice_payload: 36 dibits at s-54, 18 at s-18 + 18 at s+24, 36 at
    s+42, per burst)."""
    rows = []
    for k in range(6):
        s = SF_PERIOD * k
        rows.append(np.arange(s - 54, s - 18))
        rows.append(np.concatenate([np.arange(s - 18, s),
                                    np.arange(s + 24, s + 42)]))
        rows.append(np.arange(s + 42, s + 78))
    return np.stack(rows).astype(np.int32)


def synth_voice_stream(n_superframes: int = 8, seed: int = 0,
                       sps: int = 10):
    """Dense 2-slot DMR BS voice test/bench source: every burst on both
    slots carries 3 AMBE frames (random parameter bits through the real
    Golay/PN ECC), VC1 bursts the voice sync, VC2-6 random center bits.
    Returns (complex baseband at sps·4800 Hz, dibits, voice bits49
    [2, n_superframes*18, 49] per slot in frame order).

    The reference ships only a 2 s mostly-data DMR fixture
    (dmr_voice.iq: CSBK grants + 5 voice bursts), so sustained-voice
    throughput needs a synthesized stream — same burst geometry the
    event decoder walks (protocol/dmr/bs.py)."""
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    rng = np.random.default_rng(seed)
    vsync = next(d for d in SYNC_DEFS
                 if d.name == "+DMR BS voice")
    sync_d = np.array([int(c) for c in vsync.pattern], dtype=np.uint8)

    n_bursts = n_superframes * 6
    total = 90 + n_bursts * 288 + 200
    dib = rng.integers(0, 4, total).astype(np.uint8)
    bits49 = np.zeros((2, n_superframes * 18, 49), dtype=np.uint8)

    def put_bits(a, start, bits):
        d = ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)
        a[start:start + len(d)] = d

    for slot in (0, 1):
        for k in range(n_bursts):
            base = 90 + 288 * k + 144 * slot
            s = base + 66                      # sync-field position
            frames = []
            for f in range(3):
                b = rng.integers(0, 2, 49).astype(np.uint8)
                bits49[slot, 3 * k + f] = b
                frames.append(encode_ambe_ecc(b))
            v = np.concatenate(frames)         # 216 bits
            put_bits(dib, s - 54, v[:108])
            put_bits(dib, s + 24, v[108:])
            if k % 6 == 0:
                dib[s:s + 24] = sync_d
            else:
                # real EMB in the VC2-6 centers: QR(16,7,6) codeword
                # (cc=1, lcss varies) split around a 32-bit LC fragment
                # (protocol/dmr/bs.py _follow_superframe layout)
                from dsdneo_tpu.fec import blockcodes
                qr = blockcodes.qr_16_7_6()
                msg = (1 << 3) | ((k % 6) & 3)
                cw = qr.codebook[msg]
                center = np.zeros(48, np.uint8)
                center[0:8] = cw[:8]
                center[40:48] = cw[8:]
                center[8:40] = rng.integers(0, 2, 32)
                put_bits(dib, s, center)
    # mild Gaussian edge smoothing of the rectangular frequency pulses:
    # symbol centers keep full deviation (the channel LPF then barely
    # compresses the outer levels) while the clock line stays strong
    # for the block-global O&M timing estimate
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dib] / 3.0
    inst = np.repeat(lv, sps)
    t = np.arange(-sps // 2, sps // 2 + 1)
    g = np.exp(-0.5 * (t / (sps / 4.0)) ** 2)
    inst = np.convolve(inst, g / g.sum(), mode="same") * 0.25
    phase = np.pi * np.cumsum(inst)
    return np.exp(1j * phase).astype(np.complex64), dib, bits49


@partial(jax.jit, static_argnames=("C", "n_steps", "pcm_fmt"))
def dmr_voice_decode_gather(dibits, sf_ch, sf_pos, sf_inv, offs, fch,
                            forder, C: int, n_steps: int,
                            pcm_fmt: str = "f16", state=None):
    """Device program: superframe gather → AMBE ECC → dequant →
    scatter → repeat gate → synthesis.  Pad superframes use sf_ch == C;
    sf_inv flags inverted-polarity hits (dibit ^ 2).  ``state`` is the
    (synthesis, frame-repeat) carry from the previous block — phase-
    continuous talkers across blocks, corrupt frames repeating the
    last good parameters (≤3) before muting.  Returns (wire, state)."""
    from dsdneo_tpu.fec.device import ambe_ecc_batch
    from dsdneo_tpu.vocoder.device import (ambe_params_gated,
                                           scatter_repeat_synth,
                                           voice_state_init)

    Tn = dibits.shape[1]
    pos = jnp.clip(sf_pos[:, None, None] + offs[None], 0, Tn - 1)
    ch = jnp.minimum(sf_ch, dibits.shape[0] - 1)
    dd = dibits[ch[:, None, None], pos]
    dd = (dd ^ (sf_inv[:, None, None] * 2)).reshape(-1, 36)  # [Sp*18, 36]
    bits72 = jnp.zeros((dd.shape[0], 72), dtype=jnp.uint8)
    bits72 = bits72.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits72 = bits72.at[:, 1::2].set((dd & 1).astype(jnp.uint8))

    bits49, _errs = ambe_ecc_batch(bits72)
    w0, voiced, amps, good = ambe_params_gated(bits49, _errs)
    if state is None:
        state = voice_state_init(C)
    return scatter_repeat_synth(w0, voiced, amps, good, fch, forder,
                                C, n_steps, state, pcm_fmt)


_MULAW_LUT: np.ndarray | None = None


def mulaw_expand(q: np.ndarray) -> np.ndarray:
    """Host-side G.711 µ-law expansion (inverse of the device encode).
    256-entry lookup instead of a per-sample pow()."""
    global _MULAW_LUT
    if _MULAW_LUT is None:
        y = np.arange(256, dtype=np.float32) / 127.5 - 1.0
        _MULAW_LUT = (np.sign(y) * ((1.0 + 255.0) ** np.abs(y) - 1.0)
                      / 255.0).astype(np.float32)
    return _MULAW_LUT[q]


class BatchedDmrVoicePipeline(VoiceCarryMixin):
    """Drives the batched DMR voice chain over one [C, B] block."""

    SYNC_NAMES = ("+DMR BS voice", "-DMR BS voice")
    SYNC_TOPK = 128             # ~17 superframes per slot in 3 s + slack

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, pcm_fmt: str = "f16"):
        # acceptance = score threshold AND EMB confidence: the VC2/VC3
        # QR(16,7,6) EMBs after a true VC1 sync must ML-decode with ≤1
        # bit error each (2 total) — the reference's voice-acquisition
        # gate (dmr_bs.c check_dmr_bs_emb_and_confidence); a random
        # 32-bit center survives with probability ~0.1%
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        self.C = C
        self.fs = fs
        self.mode = MODES["dmr"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self._offs = jnp.asarray(_sf_frame_offsets())
        self.pcm_fmt = pcm_fmt

    def frontend_sync_device(self, iq):
        """Fused front end + voice-sync correlation; dibits stay on
        device, only the top-K candidate blob is fetched."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("dmr", B, n_sym)
        if not hasattr(self, "_jits"):
            self._jits = {}
        fn = self._jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(names)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            from dsdneo_tpu.fec import blockcodes
            qr_cb = blockcodes.qr_16_7_6().codebook   # [128, 16]

            @jax.jit
            def fn(x):
                dibits, soft, _power = frontend_step(
                    x, taps, self.sps, n_sym, self.mode.four_level)
                sc = correlate_syncs_device(soft, names)
                best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
                bs = jnp.max(sc, axis=1)
                vals, idx = jax.lax.top_k(bs, k_cand)
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                dq = jnp.take_along_axis(best_def, idx, axis=1)
                # EMB confidence, the reference's voice-acquisition gate
                # (dmr_bs.c check_dmr_bs_emb_and_confidence): the VC2/VC3
                # bursts after a true VC1 sync carry QR(16,7,6) EMBs —
                # ML-decode both for every candidate, summed bit errors
                Cn = dibits.shape[0]
                Tn = dibits.shape[1]
                errs_tot = jnp.zeros(idx.shape, jnp.int32)
                cb = jnp.asarray(qr_cb)
                pm = jnp.asarray((1.0 - 2.0 * qr_cb).astype(np.float32))
                for burst in (1, 2):
                    base = jnp.clip(idx + SF_PERIOD * burst, 0, Tn - 25)
                    offs16 = jnp.concatenate(
                        [jnp.arange(4), jnp.arange(20, 24)])   # dibits
                    gp = base[:, :, None] + offs16[None, None]
                    dd = dibits[jnp.arange(Cn)[:, None, None], gp]
                    # inverted candidates flip dibit polarity (SYNC_NAMES
                    # orders +/- so odd def index = inverted)
                    inv = (dq & 1).astype(jnp.uint8)
                    dd = dd ^ (inv[:, :, None] * 2)
                    b16 = jnp.stack([(dd >> 1) & 1, dd & 1],
                                    axis=-1).reshape(Cn, -1, 16)
                    s = 1.0 - 2.0 * b16.astype(jnp.float32)
                    sc16 = jnp.einsum("ckb,eb->cke", s, pm,
                                      precision=jax.lax.Precision.HIGHEST)
                    m = jnp.argmax(sc16, axis=-1)
                    errs_tot += jnp.sum(cb[m] != b16, axis=-1
                                        ).astype(jnp.int32)
                eq = jnp.clip(errs_tot, 0, 255).astype(jnp.uint8)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return dibits, jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq, dq, eq], axis=1)
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return self.frontend_finish((dibits_dev, blob_dev, n_sym))

    def frontend_dispatch(self, iq):
        """Queue the frontend program WITHOUT fetching the blob (deep
        pipelining, see voicebatch.frontend_dispatch)."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("dmr", B, n_sym)
        fn = self._jits.get(key) if hasattr(self, "_jits") else None
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
        idx = blob[:, :2 * k_cand].copy().view(np.uint16).astype(np.int64)
        vq = blob[:, 2 * k_cand:3 * k_cand]
        dq = blob[:, 3 * k_cand:4 * k_cand]
        eq = blob[:, 4 * k_cand:5 * k_cand]
        out = (dibits_dev, idx, vq, dq, eq, n_sym)
        return (out, _co) if cofetch is not None else out

    def pick_superframes(self, idx, vq, dq, eq, n_sym: int):
        """Voice-sync hits → accepted superframe (channel, pos,
        inverted) lists + per-frame channel/step indices (18 frames per
        superframe).  Acceptance requires both the correlation
        threshold and the VC2+VC3 EMB confidence (≤2 summed QR bit
        errors, computed on device)."""
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        acc_c, acc_t, acc_i, fch, forder = [], [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = (sc >= self.threshold) & (eq[c] <= 2)
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order].tolist()
            pdefs = dq[c][ok][order].tolist()
            svals = sc[ok][order].tolist()
            n_order = 0
            last = -10 ** 9
            j = 0
            n_cand = len(positions)
            while j < n_cand:
                t = positions[j]
                # shoulder suppression: a true sync peaks once; same-
                # slot superframes are 1728 dibits apart, the other
                # slot's at ±144 — anything closer is a peak shoulder
                if t - last < 24:
                    j += 1
                    continue
                # local-max refinement within one short-sync length:
                # fractional timing spreads the peak, and for X2 (no
                # EMB confidence column) a shoulder 2 dibits early
                # would otherwise misalign the whole superframe
                w = j
                k = j + 1
                while k < n_cand and positions[k] < t + 8:
                    if svals[k] > svals[w]:
                        w = k
                    k += 1
                t = positions[w]
                dfi = pdefs[w]
                j = k
                # bounds on the REFINED position (it can sit up to 7
                # dibits past the cluster head)
                if t < 54 or t + SF_EXTENT >= n_sym:
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
                acc_i.append(1 if defs[int(dfi)].inverted else 0)
                fch.extend([c] * 18)
                forder.extend(range(n_order, n_order + 18))
                n_order += 18
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_i, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    def decode_block_async(self, iq):
        """Dispatch one [C, B] block; returns the device PCM handle."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe6):
        dibits_dev, idx, vq, dq, eq, n_sym = fe6
        ac, at, ai, fch, forder = self.pick_superframes(idx, vq, dq, eq,
                                                        n_sym)
        S = ac.shape[0]
        if S == 0:
            return None
        n_steps = int(forder.max()) + 1
        Sp = -(-S // 16) * 16
        Tp = -(-n_steps // 36) * 36
        acp = np.full(Sp, self.C, dtype=np.int32)
        acp[:S] = ac
        atp = np.zeros(Sp, dtype=np.int32)
        atp[:S] = at
        aip = np.zeros(Sp, dtype=np.int32)
        aip[:S] = ai
        fchp = np.full(Sp * 18, self.C, dtype=np.int32)
        fchp[:S * 18] = fch
        fordp = np.zeros(Sp * 18, dtype=np.int32)
        fordp[:S * 18] = forder
        # synthesis + frame-repeat carry stays device-resident between
        # blocks (see vocoder.device.scatter_repeat_synth)
        wire, self._vstate = dmr_voice_decode_gather(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp),
            jnp.asarray(aip), self._offs,
            jnp.asarray(fchp), jnp.asarray(fordp), self.C, Tp,
            pcm_fmt=self.pcm_fmt, state=getattr(self, "_vstate", None))
        return wire

    def fetch_pcm(self, handle) -> np.ndarray:
        if handle is None:
            return np.zeros((self.C, 0), dtype=np.float32)
        from dsdneo_tpu.ops.audio_wire import wire_expand
        return wire_expand(np.asarray(handle), self.pcm_fmt, self.C)

    def decode_block(self, iq) -> np.ndarray:
        return self.fetch_pcm(self.decode_block_async(iq))
