"""Batched NXDN48/NXDN96 voice: [C, B] I/Q blocks → PCM, device-resident.

The narrowband entry of the batched family (BASELINE config "NXDN48 +
dPMR narrowband"): NXDN frames carry their FSW sync every 192 dibits,
so each accepted hit is one 80 ms frame of up to four AMBE+2 frames at
dibit offsets 38+36k of the PN-descrambled payload
(protocol/nxdn/decoder.py; reference nxdn_voice.c / nxdn_descramble.c).
The device program gathers candidate LICH bytes next to the sync
correlation; the host applies the LICH parity + profile gate (only
full-voice frames, mask 3, run on the batched path — V+FACCH
transition frames stay on the event-driven decoder) and uploads the
accepted frame positions; descramble + AMBE ECC + dequantization +
synthesis run as one device dispatch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

FRAME_DIBITS = 192              # FSW(10) + LICH(8) + payload
MAX_L = 56

_FULL_VOICE_LICH = {0x36, 0x37, 0x56, 0x57}


def _lich_parity_ok(lich_full: int) -> bool:
    """protocol/nxdn/decoder.py LICH parity convention."""
    lich = lich_full >> 1
    nbits = 7 if lich in (0x08, 0x4A, 0x48, 0x46) else 4
    parity = 0
    for k in range(7, 8 - nbits, -1):
        parity ^= (lich_full >> k) & 1
    return parity == (lich_full & 1)


# parity-valid AND full-voice profile, over all 256 LICH byte values
_LICH_FULL_VOICE_LUT = np.asarray(
    [_lich_parity_ok(v) and (v >> 1) in _FULL_VOICE_LICH
     for v in range(256)], dtype=bool)


def _voice_tables():
    """([4, 36] dibit offsets of the AMBE frames relative to the FSW
    start, [4, 36] descramble flip mask) — payload dibit p sits at
    sync+10+p and flips when p ∈ SCRAMBLE positions."""
    from dsdneo_tpu.protocol.nxdn.decoder import _pn9_scramble_positions
    scram = np.zeros(182, dtype=np.uint8)
    scram[_pn9_scramble_positions()] = 1
    offs = np.zeros((4, 36), dtype=np.int32)
    flips = np.zeros((4, 36), dtype=np.uint8)
    for k in range(4):
        p = 38 + 36 * k + np.arange(36)
        offs[k] = 10 + p
        flips[k] = scram[p]
    return offs.reshape(-1), flips.reshape(-1)


@partial(jax.jit, static_argnames=("C", "n_steps", "pcm_fmt"))
def nxdn_voice_decode_gather(dibits, f_ch, f_pos, f_inv, offs, flips,
                             fch, forder, C: int, n_steps: int,
                             pcm_fmt: str = "f16", state=None):
    """Device program: frame gather + descramble → AMBE ECC → dequant →
    scatter → repeat gate → synthesis.  Pad frames use f_ch == C.
    ``state`` is the (synthesis, frame-repeat) carry from the previous
    block (vocoder.device.scatter_repeat_synth).  Returns (wire,
    state)."""
    from dsdneo_tpu.fec.device import ambe_ecc_batch
    from dsdneo_tpu.vocoder.device import (ambe_params_gated,
                                           scatter_repeat_synth,
                                           voice_state_init)

    Tn = dibits.shape[1]
    pos = jnp.clip(f_pos[:, None] + offs[None], 0, Tn - 1)  # [Fp, 144]
    ch = jnp.minimum(f_ch, dibits.shape[0] - 1)
    dd = dibits[ch[:, None], pos]
    dd = dd ^ (f_inv[:, None] * 2) ^ (flips[None] * 2)
    dd = dd.reshape(-1, 36)                                  # [Fp*4, 36]
    bits72 = jnp.zeros((dd.shape[0], 72), dtype=jnp.uint8)
    bits72 = bits72.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits72 = bits72.at[:, 1::2].set((dd & 1).astype(jnp.uint8))

    bits49, _errs = ambe_ecc_batch(bits72)
    w0, voiced, amps, good = ambe_params_gated(bits49, _errs)
    if state is None:
        state = voice_state_init(C)
    return scatter_repeat_synth(w0, voiced, amps, good, fch, forder,
                                C, n_steps, state, pcm_fmt)


class BatchedNxdnVoicePipeline(VoiceCarryMixin):
    """Drives the batched NXDN48 voice chain over one [C, B] block."""

    SYNC_NAMES = ("+NXDN FSW", "-NXDN FSW")
    SYNC_TOPK = 128

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.55, pcm_fmt: str = "f16",
                 mode: str = "nxdn48"):
        # the 10-symbol FSW is short and correlates ~0.65 on real
        # captures, so the correlation is only a pre-filter; acceptance
        # requires a parity-valid full-voice LICH (decoded from
        # device-gathered bytes), which rejects random centers at ~2%
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        self.C = C
        self.fs = fs
        # nxdn48 and nxdn96 share the 192-dibit frame geometry, LICH
        # conventions and AMBE payload layout — only the symbol rate
        # (and therefore the channel filter) differs
        self.mode = MODES[mode]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        offs, flips = _voice_tables()
        self._offs = jnp.asarray(offs)
        self._flips = jnp.asarray(flips)
        self.pcm_fmt = pcm_fmt

    def frontend_sync_device(self, iq):
        """Fused front end + FSW correlation; per-candidate LICH bytes
        (descrambled, polarity-corrected) ride in the fetched blob."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("nxdn", B, n_sym)
        if not hasattr(self, "_jits"):
            self._jits = {}
        fn = self._jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(names)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            from dsdneo_tpu.protocol.nxdn.decoder import \
                _pn9_scramble_positions
            lich_flip = np.zeros(8, dtype=np.uint8)
            sp = set(_pn9_scramble_positions().tolist())
            for i in range(8):
                lich_flip[i] = 1 if i in sp else 0

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
                # candidate LICH: 8 dibits after the FSW, descrambled +
                # polarity-corrected; the byte is the high bit of each
                Cn = dibits.shape[0]
                Tn = dibits.shape[1]
                gp = jnp.clip(idx[:, :, None] + 10 + jnp.arange(8), 0,
                              Tn - 1)
                dd = dibits[jnp.arange(Cn)[:, None, None], gp]
                inv = (dq & 1).astype(jnp.uint8)
                dd = dd ^ (inv[:, :, None] * 2) \
                    ^ (jnp.asarray(lich_flip)[None, None] * 2)
                hib = (dd >> 1) & 1
                w = jnp.asarray([1 << (7 - i) for i in range(8)],
                                jnp.int32)
                lich = jnp.sum(hib.astype(jnp.int32) * w, axis=-1
                               ).astype(jnp.uint8)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return dibits, jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq, dq, lich], axis=1)
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return self.frontend_finish((dibits_dev, blob_dev, n_sym))

    def frontend_dispatch(self, iq):
        """Queue the frontend program WITHOUT fetching the candidate
        blob (deep pipelining, see voicebatch.frontend_dispatch)."""
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("nxdn", B, n_sym)
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
        lich = blob[:, 4 * k_cand:5 * k_cand]
        out = (dibits_dev, idx, vq, dq, lich, n_sym)
        return (out, _co) if cofetch is not None else out

    def pick_frames(self, idx, vq, dq, lich, n_sym: int):
        """FSW hits → accepted full-voice frames (channel, pos,
        inverted) + per-AMBE-frame channel/step indices.

        Vectorized over channels: the elementwise gates (threshold,
        LICH parity LUT, full-voice profile, bounds) are independent of
        acceptance history, and the only sequential rule — a frame
        starts ≥ 188 dibits after the last ACCEPTED frame — runs as a
        k-slot greedy over [C]-wide vectors (the per-candidate Python
        loop cost ~100 ms/block at C=320, ~10% of the whole step)."""
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        inv_lut = np.asarray([1 if d.inverted else 0 for d in defs],
                             dtype=np.int32)
        C, k = idx.shape
        valid = ((vq.astype(np.float32) / 127.0 >= self.threshold)
                 & _LICH_FULL_VOICE_LUT[lich]
                 & (idx + FRAME_DIBITS < n_sym))
        BIG = np.int64(1) << 40
        pos = np.where(valid, idx, BIG)
        order = np.argsort(pos, axis=1, kind="stable")
        pos = np.take_along_axis(pos, order, axis=1)
        dq_s = np.take_along_axis(dq, order, axis=1)
        # greedy stride suppression, all channels at once
        keep = np.zeros((C, k), dtype=bool)
        last = np.full(C, -10 ** 9, dtype=np.int64)
        for j in range(k):
            acc = (pos[:, j] < BIG) & (pos[:, j] - last
                                       >= FRAME_DIBITS - 4)
            keep[:, j] = acc
            last = np.where(acc, pos[:, j], last)
        cc, ss = np.nonzero(keep)
        acc_c = cc.astype(np.int32)
        acc_t = pos[cc, ss].astype(np.int32)
        acc_i = inv_lut[dq_s[cc, ss]]
        counts = keep.sum(axis=1)
        starts = np.zeros(C, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(len(cc), dtype=np.int64) - starts[cc]
        fch = np.repeat(cc.astype(np.int64), 4)
        forder = (4 * rank[:, None]
                  + np.arange(4, dtype=np.int64)).reshape(-1)
        return acc_c, acc_t, acc_i, fch, forder

    def decode_block_async(self, iq):
        return self.decode_from_frontend(
            self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe6):
        dibits_dev, idx, vq, dq, lich, n_sym = fe6
        ac, at, ai, fch, forder = self.pick_frames(idx, vq, dq, lich,
                                                   n_sym)
        F = ac.shape[0]
        if F == 0:
            return None
        n_steps = int(forder.max()) + 1
        Fp = -(-F // 32) * 32
        # 16-step Tp granularity: the wire ships Tp·160 samples/channel,
        # so pad waste is fetched bytes (the d2h link binds this chain)
        Tp = -(-n_steps // 16) * 16
        acp = np.full(Fp, self.C, dtype=np.int32)
        acp[:F] = ac
        atp = np.zeros(Fp, dtype=np.int32)
        atp[:F] = at
        aip = np.zeros(Fp, dtype=np.int32)
        aip[:F] = ai
        fchp = np.full(Fp * 4, self.C, dtype=np.int32)
        fchp[:F * 4] = fch
        fordp = np.zeros(Fp * 4, dtype=np.int32)
        fordp[:F * 4] = forder
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
