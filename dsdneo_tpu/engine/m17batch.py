"""Batched M17 stream voice: [C, B] I/Q → FN + Codec2 payload bits +
LICH on device; host Codec2 synthesis for monitored channels.

An M17 stream frame is 8 sync + 184 payload dibits (368 bits):
derandomize → QR de-interleave → 96-bit LICH (4× Golay(24,12) → 40-bit
LSF chunk + 3-bit counter) + 272-bit P2-punctured payload (FN16 +
voice128), reference src/protocol/m17/m17.c m17processHDU/STR and
m17_algorithms.c (rebuilt serially in protocol/m17/decoder.py).  Every
stage is static gather/XOR arithmetic plus two batched decoders the
device FEC library already provides: ``ml_decode_batch`` over the 4096-
word Golay codebook (one matmul) and the lane-major K=5 Viterbi
``conv_k5_decode_batch``.

Unlike the IMBE/AMBE families there is no device synthesizer: M17
voice is Codec2, which the reference also treats as an external system
library (m17.c:63-66 USE_CODEC2) and synthesizes for the ONE monitored
channel.  This pipeline does the same at fleet scale — voice bits,
frame events, and LSF link data decode for ALL channels on device;
PCM synthesis calls libcodec2 on the host only for the ``monitor``
subset (the library runs ~200× realtime/core, so synth-everything
would be host-bound).

Frame acceptance mirrors the other burst pipelines: the 8-dibit sync
correlation is only a pre-filter (short syncs false-trigger on noise);
the authoritative gate is the per-frame LICH Golay error count — every
true stream frame carries 4 decodable Golay words, junk hits fail all
four.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

FRAME_DIBITS = 192              # 8 sync + 184 payload
GOLAY_ERR_MAX = 3               # per-block acceptance (host decoder rule)


@lru_cache(maxsize=1)
def _m17_tables():
    """Static tables: 368-bit randomizer, QR interleave gather, and the
    P2 depuncture scatter indices (272 kept of 296 coded positions)."""
    from dsdneo_tpu.protocol.m17.decoder import _INTERLEAVE, _P2, _SCRAMBLE
    keep = np.flatnonzero(np.tile(_P2, 296 // len(_P2) + 1)[:296])
    assert keep.shape[0] == 272
    return (np.asarray(_SCRAMBLE[:368], np.uint8),
            np.asarray(_INTERLEAVE, np.int32),
            keep.astype(np.int32))


_PACK_W = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.int32)


def _pack8(bits: jax.Array) -> jax.Array:
    """[..., 8k] 0/1 bits → [..., k] packed uint8 (MSB first)."""
    shp = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    return jnp.sum(bits.reshape(shp).astype(jnp.int32)
                   * jnp.asarray(_PACK_W), axis=-1).astype(jnp.uint8)


@jax.jit
def m17_stream_decode_device(dibits: jax.Array, ch: jax.Array,
                             pos: jax.Array) -> jax.Array:
    """Decode F stream frames (``pos`` = sync start) → uint8 blob
    [F, 26]: FN(2) | voice bits packed(16) | LICH chunk packed(6) |
    max per-block Golay errors(1) | LICH counter+valid(1)."""
    from dsdneo_tpu.fec.blockcodes import golay_24_12
    from dsdneo_tpu.fec.device import conv_k5_decode_batch, ml_decode_batch
    scram, inter, keep = _m17_tables()
    Tn = dibits.shape[1]
    gp = jnp.clip(pos[:, None] + 8 + jnp.arange(184), 0, Tn - 1)
    cc = jnp.minimum(ch, dibits.shape[0] - 1)
    dd = dibits[cc[:, None], gp]                      # [F, 184]
    bits = jnp.zeros((dd.shape[0], 368), jnp.uint8)
    bits = bits.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits = bits.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    deframe = (bits ^ jnp.asarray(scram))[:, jnp.asarray(inter)]
    # LICH: 4 Golay(24,12) words per frame through the codebook matmul
    code = golay_24_12()
    msg, gerr = ml_decode_batch(code, deframe[:, :96].reshape(-1, 24))
    content = jnp.asarray(code.codebook)[msg][:, :12] \
        .reshape(dd.shape[0], 48).astype(jnp.uint8)   # [F, 48]
    gmax = gerr.reshape(-1, 4).max(axis=-1)           # [F]
    cnt = (content[:, 40] * 4 + content[:, 41] * 2
           + content[:, 42]).astype(jnp.uint8)
    # payload: P2 depuncture (weight 0 on punctured) → K=5 Viterbi
    sym = jnp.zeros((dd.shape[0], 296), jnp.float32)
    sym = sym.at[:, jnp.asarray(keep)].set(
        deframe[:, 96:368].astype(jnp.float32))
    wt = jnp.zeros((296,), jnp.float32).at[jnp.asarray(keep)].set(1.0)
    wt = jnp.broadcast_to(wt, sym.shape)
    b144 = conv_k5_decode_batch(sym, wt)[:, :144]
    return jnp.concatenate([
        _pack8(b144[:, :16]),                         # FN
        _pack8(b144[:, 16:144]),                      # voice
        _pack8(content),                              # LSF chunk + cnt
        jnp.minimum(gmax, 255)[:, None].astype(jnp.uint8),
        cnt[:, None],
    ], axis=1)


class _M17Chan:
    """Per-channel LSF-chunk assembly + Codec2 synthesis state."""

    def __init__(self):
        self.chunks = np.zeros((6, 40), np.uint8)
        self.ok = [False] * 6
        self.dt = 2                 # data type: default Voice (3200bps)
        self.enc = 0
        self.c2 = None


class BatchedM17VoicePipeline:
    """Drives the batched M17 stream chain over one [C, B] block."""

    SYNC_NAMES = ("+M17 STR",)
    SYNC_TOPK = 192             # 25 frames/s + shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, pcm_fmt: str = "f16",
                 monitor=None):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        from dsdneo_tpu.protocol.base import DecoderContext
        self.C = C
        self.fs = fs
        self.mode = MODES["m17"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        self.monitor = set(range(C)) if monitor is None else set(monitor)
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.chans = [_M17Chan() for _ in range(C)]
        self._active = [False] * C    # per-block stream activity
        self._jits = {}

    # -- front end (shared shape with ysfbatch: gated demod + clipped
    # correlation; M17 transmissions burst with dead-air gaps) -------------
    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def frontend_dispatch(self, iq):
        from dsdneo_tpu.engine.demod import gated_frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("m17", B, n_sym)
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
        return dibits_dev, blob_dev, n_sym

    def frontend_finish(self, fe):
        dibits_dev, blob_dev, n_sym = fe
        blob = np.asarray(blob_dev)
        defs, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        k_cand = min(self.SYNC_TOPK, n_sym - n_max + 1)
        idx = blob[:, :2 * k_cand].copy().view(np.uint16).astype(np.int64)
        vq = blob[:, 2 * k_cand:3 * k_cand]
        return dibits_dev, idx, vq, n_sym

    def pick_frames(self, idx, vq, n_sym: int):
        """Score threshold + 192-dibit spacing with local-max refinement
        (a ±1 sync offset garbles the interleave)."""
        acc_c, acc_t = [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            last = -10 ** 9
            j = 0
            while j < len(positions):
                t = int(positions[j])
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    j += 1
                    continue
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                j = k
                if t + FRAME_DIBITS >= n_sym:
                    # the refined winner (up to 7 dibits past the
                    # cluster head) can cross the block end even when
                    # the head cleared the bound above — dropping it
                    # here beats gathering a clipped, garbled frame
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
        return np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32)

    # -- full block ---------------------------------------------------------
    def decode_block_events(self, iq) -> int:
        """One [C, B] block end to end; events land in
        ``self.ctxs[c].events``, synthesized PCM for monitored channels
        in ``self.ctxs[c].audio``.  Returns accepted stream frames."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe4) -> int:
        """Second fleet-pipeline stage (see FleetMonitor.decode_block)."""
        dibits_dev, idx, vq, n_sym = fe4
        ac, at = self.pick_frames(idx, vq, n_sym)
        self._active = [False] * self.C
        F = ac.shape[0]
        if F == 0:
            return 0
        Fp = -(-F // 64) * 64
        acp = np.full(Fp, self.C, dtype=np.int32)
        acp[:F] = ac
        atp = np.zeros(Fp, dtype=np.int32)
        atp[:F] = at
        blob = np.asarray(m17_stream_decode_device(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp)))[:F]
        n_acc = 0
        for h in range(F):
            if int(blob[h, 24]) > GOLAY_ERR_MAX:
                continue                      # LICH gate: not a frame
            n_acc += 1
            self._frame(int(ac[h]), int(at[h]), blob[h])
        return n_acc

    def _frame(self, c: int, t: int, rec: np.ndarray) -> None:
        from dsdneo_tpu.protocol.m17.decoder import (DT_NAMES, ENC_NAMES,
                                                     _pack_bytes,
                                                     decode_callsign,
                                                     m17_crc16)
        ctx = self.ctxs[c]
        st = self.chans[c]
        fn = (int(rec[0]) << 8) | int(rec[1])
        cnt = int(rec[25])
        line = f"Sync: +M17 STR "
        if cnt > 5:
            ctx.emit(line + "LICH CNT ERR", "m17", t)
            return
        line += f"LC: {cnt + 1}/6 FN: {fn & 0x7FFF:04X} "
        if fn & 0x8000:
            line += "EOT "
        st.chunks[cnt] = np.unpackbits(rec[18:23])
        st.ok[cnt] = True
        detail = ""
        if cnt == 5 and all(st.ok):
            lsf = st.chunks.reshape(-1)
            if m17_crc16(_pack_bytes(lsf)) == 0:
                dst = int.from_bytes(np.packbits(lsf[0:48]).tobytes(), "big")
                src = int.from_bytes(np.packbits(lsf[48:96]).tobytes(), "big")
                tw = (int(np.packbits(lsf[96:104])[0]) << 8) \
                    | int(np.packbits(lsf[104:112])[0])
                cn = (tw >> 7) & 0xF
                if tw & 1:
                    st.dt = (tw >> 1) & 3
                    st.enc = (tw >> 3) & 3
                detail = (f"\n CAN: {cn} DST: {decode_callsign(dst)}"
                          f" SRC: {decode_callsign(src)}"
                          f"{DT_NAMES.get(st.dt, '')}"
                          f"{ENC_NAMES.get(st.enc, '') if st.enc else ''}")
                ctx.state.last_src = decode_callsign(src)
            st.ok = [False] * 6
        ctx.emit(line + detail, "m17", t, fn=fn & 0x7FFF, lich_cnt=cnt)
        self._active[c] = True
        if c in self.monitor and st.enc == 0:
            self._voice(ctx, st, rec[2:18])

    def channel_state(self, c: int) -> str:
        """Fleet channel-grid state: 'voice' while the last block
        carried accepted stream frames, else 'idle'."""
        return "voice" if self._active[c] else "idle"

    @staticmethod
    def _synth(st: _M17Chan, voice16: np.ndarray) -> np.ndarray | None:
        from dsdneo_tpu.vocoder import codec2 as c2
        if not c2.available():
            return None
        mode = c2.MODE_3200 if st.dt != 3 else c2.MODE_1600
        if st.c2 is None or st.c2.mode != mode:
            st.c2 = c2.Codec2(mode)
        v1 = voice16[:8].tobytes()
        if st.dt == 3:
            return st.c2.decode(v1)
        return np.concatenate([st.c2.decode(v1),
                               st.c2.decode(voice16[8:16].tobytes())])

    def _voice(self, ctx, st: _M17Chan, voice16: np.ndarray) -> None:
        pcm = self._synth(st, voice16)
        if pcm is not None:
            ctx.emit_audio(pcm.astype(np.float32) / 32768.0)

    def decode_block(self, iq) -> np.ndarray:
        """FleetMonitor voice-group surface: one block → [C, n] PCM of
        the audio synthesized BY this block (monitored channels only;
        events keep accumulating in ``self.ctxs``)."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe4) -> np.ndarray:
        """Staged voice surface for the fleet pipeline: events + the
        block's new PCM from a finished frontend exchange."""
        before = [sum(len(p) for p in ctx.audio.get(0, []))
                  for ctx in self.ctxs]
        self.events_from_frontend(fe4)
        chans = [self.pcm(c)[before[c]:] for c in range(self.C)]
        n = max((ch.size for ch in chans), default=0)
        out = np.zeros((self.C, n), np.float32)
        for c, ch in enumerate(chans):
            out[c, :ch.size] = ch
        return out

    @staticmethod
    def fetch_pcm(handle) -> np.ndarray:
        """decode_from_frontend already returns host PCM."""
        return handle

    def events(self, c: int):
        return self.ctxs[c].events

    def pcm(self, c: int) -> np.ndarray:
        parts = self.ctxs[c].audio.get(0, [])
        if not parts:
            return np.zeros(0, np.float32)
        return np.concatenate(parts)

    # parity hook: raw per-frame records without event emission
    def decode_block_records(self, iq):
        dibits_dev, idx, vq, n_sym = self.frontend_sync_device(iq)
        ac, at = self.pick_frames(idx, vq, n_sym)
        if ac.size == 0:
            return ac, at, np.zeros((0, 26), np.uint8)
        blob = np.asarray(m17_stream_decode_device(
            dibits_dev, jnp.asarray(ac), jnp.asarray(at)))
        return ac, at, blob
