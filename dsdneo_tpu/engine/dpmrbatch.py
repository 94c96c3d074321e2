"""Batched dPMR voice: [C, B] I/Q blocks → PCM, device-resident.

dPMR (2400 sym/s narrowband, BASELINE config "NXDN48 + dPMR
narrowband") FS2 superframe parts carry two TCH groups of 4 AMBE+2
frames each (protocol/dpmr/decoder.py _voice; reference
src/protocol/dpmr/dpmr_voice.c dpmr_read_tch_group): 36-dibit frames
at offsets 48+36k and 240+36k from the FS2 sync start, no voice
scrambling.  The device program is the NXDN gather with dPMR offsets
and a zero flip mask — AMBE Golay/PN ECC, dequantization and harmonic
synthesis run as one dispatch; over-threshold/tone frames are muted by
the shared AMBE mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.nxdnbatch import nxdn_voice_decode_gather
from dsdneo_tpu.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

PART_DIBITS = 384               # FS2-to-FS2 stride (12 sync + 372 part)
FRAMES_PER_PART = 8


def _voice_offsets() -> np.ndarray:
    """[8·36] dibit offsets of the part's AMBE frames relative to the
    FS2 sync START (sync is 12 dibits; groups at part+36 and
    part+228)."""
    offs = []
    for base in (12 + 36, 12 + 36 + 144 + 12 + 36):
        for k in range(4):
            offs.append(base + 36 * k + np.arange(36))
    return np.concatenate(offs).astype(np.int32)


class BatchedDpmrVoicePipeline(VoiceCarryMixin):
    """Drives the batched dPMR voice chain over one [C, B] block."""

    SYNC_NAMES = ("+dPMR FS2", "-dPMR FS2")
    SYNC_TOPK = 64

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, pcm_fmt: str = "f16"):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        self.C = C
        self.fs = fs
        self.mode = MODES["dpmr"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        self._offs = jnp.asarray(_voice_offsets())
        self._flips = jnp.asarray(np.zeros(FRAMES_PER_PART * 36, np.uint8))
        self._jits = {}

    def frontend_sync_device(self, iq):
        """Power-gated front end (engine.demod.gated_frontend_step):
        dPMR transmissions are bursty like YSF."""
        from dsdneo_tpu.engine.demod import gated_frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("dpmr", B, n_sym)
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
                best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
                bs = jnp.max(sc, axis=1)
                vals, idx = jax.lax.top_k(bs, k_cand)
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                dq = jnp.take_along_axis(best_def, idx, axis=1)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return dibits, jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq, dq], axis=1)
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return self.frontend_finish((dibits_dev, blob_dev, n_sym))

    def frontend_dispatch(self, iq):
        """Queue the frontend program WITHOUT fetching the candidate
        blob (deep pipelining, see voicebatch.frontend_dispatch)."""
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("dpmr", B, n_sym)
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
        out = (dibits_dev, idx, vq, dq, n_sym)
        return (out, _co) if cofetch is not None else out

    def pick_parts(self, idx, vq, dq, n_sym: int):
        """Score threshold + local-max refinement + 384-dibit stride;
        pattern 1 (inverted FS2) flips dibit polarity."""
        acc_c, acc_t, acc_i, fch, forder = [], [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            pdefs = dq[c][ok][order]
            last = -10 ** 9
            n_ord = 0
            j = 0
            while j < len(positions):
                t = int(positions[j])
                if t - last < PART_DIBITS - 8 \
                        or t + PART_DIBITS >= n_sym:
                    j += 1
                    continue
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                inv = int(pdefs[w]) & 1
                j = k
                if t + PART_DIBITS >= n_sym:
                    # refined winner (up to +7) can cross the block
                    # end even when the cluster head cleared the bound
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
                acc_i.append(inv)
                fch.extend([c] * FRAMES_PER_PART)
                forder.extend(range(n_ord, n_ord + FRAMES_PER_PART))
                n_ord += FRAMES_PER_PART
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_i, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    def decode_block_async(self, iq):
        return self.decode_from_frontend(
            self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe6):
        dibits_dev, idx, vq, dq, n_sym = fe6
        ac, at, ai, fch, forder = self.pick_parts(idx, vq, dq, n_sym)
        F = ac.shape[0]
        if F == 0:
            return None
        n_steps = int(forder.max()) + 1
        Fp = -(-F // 16) * 16
        Tp = -(-n_steps // 16) * 16
        acp = np.full(Fp, self.C, dtype=np.int32)
        acp[:F] = ac
        atp = np.zeros(Fp, dtype=np.int32)
        atp[:F] = at
        aip = np.zeros(Fp, dtype=np.int32)
        aip[:F] = ai
        fchp = np.full(Fp * FRAMES_PER_PART, self.C, dtype=np.int32)
        fchp[:F * FRAMES_PER_PART] = fch
        fordp = np.zeros(Fp * FRAMES_PER_PART, dtype=np.int32)
        fordp[:F * FRAMES_PER_PART] = forder
        wire, self._vstate = nxdn_voice_decode_gather(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp),
            jnp.asarray(aip), self._offs, self._flips,
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
