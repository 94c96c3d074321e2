"""Batched YSF V/D2 voice: [C, B] I/Q blocks → PCM, device-resident.

System Fusion's DN (V/D2) mode carries 5 AMBE+2 frames per 480-dibit
frame (reference src/protocol/ysf/ysf.c ysf_read_type2_vech_bits /
ysf_build_type2_ambe, rebuilt in protocol/ysf/decoder.py _voice_vd2):
each 52-dibit voice block de-interleaves (4×26), PN-dewhitens, and
majority-votes the tripled 27-bit protected prefix into a 49-bit AMBE
frame.  All of that is static index/mask arithmetic — one device
gather per block.

Frame acceptance runs on sync score + shoulder suppression only; the
per-frame MAJORITY-VOTE DISAGREEMENT count gates synthesis on device
(clean V/D2 voice votes ~unanimously; data/DCH frames or noise
disagree on most triplets and are muted) — the YSF analog of the DMR
pipeline's EMB-confidence gate.  FICH typing/DCH callsign decode stay
on the event-driven path.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

FRAME_DIBITS = 480              # sync 20 + FICH 100 + payload 360
MAX_L = 56
VOTE_ERR_MAX = 5                # ≤5 disagreeing triplets of 27 = voice


@lru_cache(maxsize=1)
def _vd2_tables():
    """Static per-block tables: [5, 52] dibit offsets from the sync
    start, the bit-level inverse de-interleave [104], and the PN mask
    [104] (protocol/ysf/decoder.py conventions)."""
    from dsdneo_tpu.protocol.ysf.decoder import _PN95_512
    offs = np.zeros((5, 52), dtype=np.int32)
    for blk in range(5):
        offs[blk] = 120 + 72 * blk + 20 + np.arange(52)
    out_idx = (np.arange(104) % 4) * 26 + np.arange(104) // 4
    inv = np.argsort(out_idx).astype(np.int32)    # bits104[i] = raw[inv[i]]
    pn = np.asarray(_PN95_512[:104], dtype=np.uint8)
    return offs, inv, pn


@partial(jax.jit, static_argnames=("C", "n_steps", "pcm_fmt"))
def ysf_voice_decode_gather(dibits, f_ch, f_pos, fch, forder,
                            C: int, n_steps: int, pcm_fmt: str = "f16",
                            state=None):
    """Device program: V/D2 block gather → de-interleave + PN → tripled
    majority vote → AMBE dequant (vote-gated) → scatter → repeat gate →
    synthesis.  ``f_pos`` is the frame's SYNC position; each accepted
    frame expands to 5 AMBE steps (fch/forder are per-AMBE-frame);
    ``state`` is the (synthesis, frame-repeat) carry from the previous
    block.  Returns (wire, state)."""
    from dsdneo_tpu.vocoder.device import (ambe_params_gated,
                                           scatter_repeat_synth,
                                           voice_state_init)
    offs, inv, pn = _vd2_tables()
    Tn = dibits.shape[1]
    pos = jnp.clip(f_pos[:, None, None] + jnp.asarray(offs)[None],
                   0, Tn - 1)                            # [F, 5, 52]
    ch = jnp.minimum(f_ch, dibits.shape[0] - 1)
    dd = dibits[ch[:, None, None], pos].reshape(-1, 52)  # [F*5, 52]
    raw = jnp.zeros((dd.shape[0], 104), dtype=jnp.uint8)
    raw = raw.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    raw = raw.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    bits = raw[:, jnp.asarray(inv)] ^ jnp.asarray(pn)    # [F*5, 104]
    # tripled-bit majority vote over the protected 27-bit prefix
    tri = bits[:, :81].reshape(-1, 27, 3)
    s = tri.sum(axis=-1)
    ambe = jnp.concatenate([(s >= 2).astype(jnp.uint8),
                            bits[:, 81:103]], axis=1)    # [F*5, 49]
    vote_errs = jnp.sum((s != 0) & (s != 3), axis=-1)    # [F*5]

    w0, voiced, amps, good = ambe_params_gated(ambe, vote_errs,
                                               thr=VOTE_ERR_MAX)
    if state is None:
        state = voice_state_init(C)
    return scatter_repeat_synth(w0, voiced, amps, good, fch, forder,
                                C, n_steps, state, pcm_fmt)


class BatchedYsfVoicePipeline(VoiceCarryMixin):
    """Drives the batched YSF V/D2 chain over one [C, B] block."""

    SYNC_NAMES = ("+YSF",)
    SYNC_TOPK = 64              # 10 frames/s + shoulders

    # off-air YSF deviation compresses the soft symbols, so the 20-
    # dibit sync correlates ~0.59; the correlation is only a pre-filter
    # here — acceptance is the per-frame majority-vote gate
    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.5, pcm_fmt: str = "f16"):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        self.C = C
        self.fs = fs
        self.mode = MODES["ysf"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        self._jits = {}

    def frontend_sync_device(self, iq):
        """Front end + sync dispatch.  YSF transmissions burst with
        dead-air gaps, so this pipeline uses the power-gated demod
        chain (engine.demod semantics: discriminator samples below 2%
        of peak power are zeroed before timing/level estimation) — the
        min/max level windows of the fused frontend_step blow up on
        silence."""
        from dsdneo_tpu.engine.demod import gated_frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("ysf", B, n_sym)
        fn = self._jits.get(key)
        if fn is None:
            taps = jnp.asarray(self.taps)
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(names)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            sps = self.sps

            @jax.jit
            def fn(x):
                dibits, soft = gated_frontend_step(
                    x, taps, sps, n_sym, self.mode.four_level)
                # clip the correlation input: residual dead-air spikes
                # (huge discriminator excursions the power gate missed)
                # would otherwise crowd the top-k with junk positions
                sc = correlate_syncs_device(
                    jnp.clip(soft, -3.5, 3.5), names)
                bs = jnp.max(sc, axis=1)
                vals, idx = jax.lax.top_k(bs, k_cand)
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return dibits, jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq], axis=1)
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return self.frontend_finish((dibits_dev, blob_dev, n_sym))

    def frontend_dispatch(self, iq):
        """Queue the frontend program WITHOUT fetching the candidate
        blob (deep pipelining, see voicebatch.frontend_dispatch)."""
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("ysf", B, n_sym)
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
        out = (dibits_dev, idx, vq, n_sym)
        return (out, _co) if cofetch is not None else out

    def pick_frames(self, idx, vq, n_sym: int):
        """Score threshold + 480-dibit shoulder suppression; every
        accepted frame expands to 5 AMBE steps (the vote gate mutes
        non-voice frames on device)."""
        acc_c, acc_t, fch, forder = [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            last = -10 ** 9
            n_ord = 0
            j = 0
            while j < len(positions):
                t = int(positions[j])
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    j += 1
                    continue
                # local-max refinement: a ±1 sync offset garbles the
                # whole V/D2 extraction, so take the best-scoring
                # candidate within the peak's 8-position shoulder
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                j = k
                if t + FRAME_DIBITS >= n_sym:
                    # refined winner (up to +7) can cross the block
                    # end even when the cluster head cleared the bound
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
                fch.extend([c] * 5)
                forder.extend(range(n_ord, n_ord + 5))
                n_ord += 5
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    def decode_block_async(self, iq):
        return self.decode_from_frontend(
            self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe6):
        dibits_dev, idx, vq, n_sym = fe6
        ac, at, fch, forder = self.pick_frames(idx, vq, n_sym)
        F = ac.shape[0]
        if F == 0:
            return None
        n_steps = int(forder.max()) + 1
        Fp = -(-F // 16) * 16
        Tp = -(-n_steps // 20) * 20
        acp = np.full(Fp, self.C, dtype=np.int32)
        acp[:F] = ac
        atp = np.zeros(Fp, dtype=np.int32)
        atp[:F] = at
        fchp = np.full(Fp * 5, self.C, dtype=np.int32)
        fchp[:F * 5] = fch
        fordp = np.zeros(Fp * 5, dtype=np.int32)
        fordp[:F * 5] = forder
        wire, self._vstate = ysf_voice_decode_gather(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp),
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

    def decode_block_bits49(self, iq):
        """Parity hook: the extracted 49-bit AMBE frames + vote-error
        counts in dispatch order (compares against the serial
        _voice_vd2 extraction)."""
        dibits_dev, idx, vq, n_sym = self.frontend_sync_device(iq)
        ac, at, fch, forder = self.pick_frames(idx, vq, n_sym)
        if ac.size == 0:
            return np.zeros((0, 49), np.uint8), np.zeros(0, np.int64)
        offs, inv, pn = _vd2_tables()

        @jax.jit
        def _bits(dd, chv, posv):
            Tn = dd.shape[1]
            gp = jnp.clip(posv[:, None, None] + jnp.asarray(offs)[None],
                          0, Tn - 1)
            ch = jnp.minimum(chv, dd.shape[0] - 1)
            d2 = dd[ch[:, None, None], gp].reshape(-1, 52)
            raw = jnp.zeros((d2.shape[0], 104), dtype=jnp.uint8)
            raw = raw.at[:, 0::2].set(((d2 >> 1) & 1).astype(jnp.uint8))
            raw = raw.at[:, 1::2].set((d2 & 1).astype(jnp.uint8))
            bits = raw[:, jnp.asarray(inv)] ^ jnp.asarray(pn)
            tri = bits[:, :81].reshape(-1, 27, 3)
            s = tri.sum(axis=-1)
            ambe = jnp.concatenate([(s >= 2).astype(jnp.uint8),
                                    bits[:, 81:103]], axis=1)
            return ambe, jnp.sum((s != 0) & (s != 3), axis=-1)
        ambe, verr = _bits(dibits_dev, jnp.asarray(ac), jnp.asarray(at))
        return np.asarray(ambe), np.asarray(verr)
