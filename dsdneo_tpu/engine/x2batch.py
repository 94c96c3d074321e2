"""Batched X2-TDMA voice: [C, B] I/Q blocks → PCM, device-resident.

X2-TDMA's voice superframe geometry is DMR's (protocol/x2tdma/decoder
_voice_superframe; reference processX2TDMAvoice): 6 bursts at the
288-dibit same-slot period, 3 AMBE+2 frames per burst at the same
payload offsets — so the device program IS engine.dmrbatch's
superframe gather (dmr_voice_decode_gather) with X2's sync patterns.
Acceptance differs: X2 embeds P25-style LC/ES signalling (not QR EMBs)
in the mid-superframe centers, so the pipeline gates on sync score +
the shared device AMBE-ECC mask rather than DMR's EMB confidence.
Embedded LC/encryption-sync decode stays on the event-driven path.

No reference e2e fixture exists for X2 (docs/testing.md fixture gaps),
so validation is synthetic through the real ECC, cross-checked against
the serial x2tdma decoder.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from dsdneo_tpu.engine.dmrbatch import (SF_EXTENT, SF_PERIOD,
                                        BatchedDmrVoicePipeline,
                                        _sf_frame_offsets,
                                        dmr_voice_decode_gather)
from dsdneo_tpu.engine.voicebatch import _sync_kernel


def synth_x2_voice_stream(n_superframes: int = 4, seed: int = 0,
                          sps: int = 8):
    """Dense 2-slot X2-TDMA voice stream through the real AMBE ECC:
    VC1 bursts carry the X2 BS voice sync; the other centers carry
    random embedded signalling (never a data sync).  Returns (complex
    baseband, dibits, bits49 [2, n_superframes·18, 49])."""
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    rng = np.random.default_rng(seed)
    vsync = next(d for d in SYNC_DEFS if d.name == "+X2-TDMA BS voice")
    dsync = next(d for d in SYNC_DEFS if d.name == "+X2-TDMA BS data")
    sync_d = np.array([int(c) for c in vsync.pattern], dtype=np.uint8)
    data_d = np.array([int(c) for c in dsync.pattern], dtype=np.uint8)

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
            s = base + 66
            frames = []
            for f in range(3):
                b = rng.integers(0, 2, 49).astype(np.uint8)
                bits49[slot, 3 * k + f] = b
                frames.append(encode_ambe_ecc(b))
            v = np.concatenate(frames)
            put_bits(dib, s - 54, v[:108])
            put_bits(dib, s + 24, v[108:])
            if k % 6 == 0:
                dib[s:s + 24] = sync_d
            else:
                # embedded signalling center: random, but never a
                # data sync (which would end the superframe) and never
                # aliasing the voice sync
                while True:
                    center = rng.integers(0, 4, 24).astype(np.uint8)
                    if not np.array_equal(center | 1, data_d | 1) and \
                            not np.array_equal(center | 1, sync_d | 1):
                        break
                dib[s:s + 24] = center
    # C4FM shaping at 6000 sym/s (X2 runs the P25 rate; the half-
    # symbol moving average + ±1800 Hz deviation the demod is tuned to)
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dib]
    inst = np.repeat(lv, sps) * (1800.0 / 3.0)
    k = max(sps // 2, 1)
    inst = np.convolve(inst, np.ones(k) / k, mode="same")
    phase = 2 * np.pi * np.cumsum(inst) / (sps * 6000.0)
    return np.exp(1j * phase).astype(np.complex64), dib, bits49


class BatchedX2VoicePipeline(BatchedDmrVoicePipeline):
    """X2-TDMA over the DMR superframe device program: only the symbol
    rate (6000), sync patterns and the acceptance gate differ."""

    SYNC_NAMES = ("+X2-TDMA BS voice", "+X2-TDMA MS voice")
    SYNC_TOPK = 128

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, pcm_fmt: str = "f16"):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        super().__init__(C, fs=fs, sync_threshold=sync_threshold,
                         pcm_fmt=pcm_fmt)
        self.mode = MODES["x2tdma"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)

    def frontend_sync_device(self, iq):
        """The DMR fused dispatch computes a QR EMB-confidence column
        that X2's embedded signalling does not satisfy; this variant
        runs the same front end + correlation and returns a zero
        confidence column (acceptance is score + the device AMBE
        mask)."""
        import jax
        from dsdneo_tpu.engine.batched import frontend_step
        from dsdneo_tpu.engine.voicebatch import correlate_syncs_device
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("x2", B, n_sym)
        if not hasattr(self, "_jits"):
            self._jits = {}
        fn = self._jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(names)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)

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
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return dibits, jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq, dq], axis=1)
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jnp.ndarray) else jnp.asarray(iq))
        return self.frontend_finish((dibits_dev, blob_dev, n_sym))

    def frontend_dispatch(self, iq):
        """X2 override of the deep-pipelining dispatch (own jit key +
        blob layout; see voicebatch.frontend_dispatch)."""
        import jax
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("x2", B, n_sym)
        fn = self._jits.get(key) if hasattr(self, "_jits") else None
        if fn is None:
            self.frontend_sync_device(iq)   # compile once
            fn = self._jits[key]
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jnp.ndarray) else jnp.asarray(iq))
        return dibits_dev, blob_dev, n_sym

    def frontend_finish(self, fe):
        dibits_dev, blob_dev, n_sym = fe
        blob = np.asarray(blob_dev)
        defs, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        k_cand = min(self.SYNC_TOPK, n_sym - n_max + 1)
        idx = blob[:, :2 * k_cand].copy().view(np.uint16).astype(np.int64)
        vq = blob[:, 2 * k_cand:3 * k_cand]
        dq = blob[:, 3 * k_cand:4 * k_cand]
        eq = np.zeros_like(vq)          # gate satisfied; AMBE mask rules
        return dibits_dev, idx, vq, dq, eq, n_sym
