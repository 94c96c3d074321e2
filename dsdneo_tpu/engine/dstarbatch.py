"""Batched D-STAR fleet pipeline: [C, B] I/Q → RF headers + slow-data
events + raw AMBE voice bits, device-resident.

D-STAR (GMSK 4800 bps, 2-level) interleaves two frame kinds behind two
24-dibit syncs (reference src/protocol/dstar/dstar.c, rebuilt serially
in protocol/dstar/decoder.py):

* RF header — 660 coded bits: x⁷+x⁴+1 LFSR descramble → 24-stride block
  de-interleave → rate-1/2 K=3 Viterbi → 41 octets + CRC-16/X25.  On
  device that is one XOR, one static gather, and the lane-major
  ``fec.device.conv_k3_decode_batch`` (bit-identical to the host
  ``_viterbi_k3`` lattice).
* Voice superframe — 21×72 AMBE bits with 20×24 slow-data bits between
  frames (sync replaces the 21st data field): the 480 slow-data bits
  XOR-descramble with the repeating 0x0EF2C9 pattern and pack to 60
  bytes (LSB-first per byte — the algebraic collapse of the host
  reverse-then-MSB walk), carrying 6-byte blocks that reassemble radio
  text / DPRS position / a copy of the RF header
  (src/protocol/dstar/dstar_slow_data.c).

The 72-bit AMBE frames run the recovered 3600x2400 ECC on device
(fec.device.dstar_ambe_ecc_batch — dual Golay + PN, zero-error on the
off-air fixture, see protocol/dstar/ambe2400.py): events carry raw
bits, FEC-validated 49-bit parameter frames, and per-frame error
counts.  The inner parameter fields remain VQ/delta-coded (PARITY.md),
so like the M17 pipeline this is an events pipeline — headers, link
text, DPRS, and validated voice parameters for ALL channels on device,
no PCM synthesis.

Acceptance: off-air GMSK compresses the 24-dibit sync correlation to
~0.55-0.67 while preamble/noise hits reach ~0.52, so the score is only
a pre-filter.  The authoritative voice gate is the SUPERFRAME CHAIN —
a true voice sync has a partner sync at exactly ±2016 dibits (the
sync replaces every 21st data field), which junk hits essentially
never satisfy; headers gate on their CRC-16/X25 (weak-scoring headers
must pass it to emit).  A single isolated superframe (sub-0.5 s key-up
with no neighbor) is dropped by design — the serial decoder remains
the single-channel path.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.voicebatch import _sync_kernel, correlate_syncs_device

VOICE_EXTENT = 2016             # sync 24 + 21*72 voice + 20*24 slow data
HEADER_EXTENT = 684             # sync 24 + 660 coded header bits


@lru_cache(maxsize=1)
def _dstar_tables():
    """Static tables: 660-bit header scramble, the inverse of the
    24-stride header interleave (dei = b[inv]), and the tiled 480-bit
    slow-data scramble (protocol/dstar/decoder.py conventions)."""
    from dsdneo_tpu.protocol.dstar.decoder import (SD_SCRAMBLE,
                                                   _header_scramble)
    scram = np.resize(_header_scramble(), 660).astype(np.uint8)
    dest = np.zeros(660, dtype=np.int64)
    k = 0
    for i in range(660):
        dest[i] = k
        k += 24
        if k >= 672:
            k -= 671
        elif k >= 660:
            k -= 647
    inv = np.argsort(dest).astype(np.int32)       # dei[j] = b[inv[j]]
    sd_scram = np.tile(SD_SCRAMBLE, 20).astype(np.uint8)
    return scram, inv, sd_scram


@lru_cache(maxsize=1)
def _voice_offsets():
    """Dibit offsets from the sync start: [21, 72] voice and [20, 24]
    slow data (voice frame j at 24+96j; its data field follows)."""
    voff = 24 + 96 * np.arange(21)[:, None] + np.arange(72)[None]
    doff = 24 + 96 * np.arange(20)[:, None] + 72 + np.arange(24)[None]
    return voff.astype(np.int32), doff.astype(np.int32)


_LSB_W = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.int32)
_MSB_W = _LSB_W[::-1].copy()


def _pack(bits: jax.Array, weights: np.ndarray) -> jax.Array:
    shp = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    return jnp.sum(bits.reshape(shp).astype(jnp.int32)
                   * jnp.asarray(weights), axis=-1).astype(jnp.uint8)


def _gather_bits(dibits: jax.Array, ch: jax.Array, pos: jax.Array,
                 offs: np.ndarray) -> jax.Array:
    """[F] hits × static offsets → 0/1 bits (2-level: dibit 3 → 1,
    decoder.py DstarDecoder._bits convention)."""
    Tn = dibits.shape[1]
    gp = jnp.clip(pos.reshape(pos.shape + (1,) * offs.ndim)
                  + jnp.asarray(offs)[None], 0, Tn - 1)
    cc = jnp.minimum(ch, dibits.shape[0] - 1)
    cc = cc.reshape(cc.shape + (1,) * offs.ndim)
    return ((dibits[cc, gp] >> 1) & 1).astype(jnp.uint8)


@jax.jit
def dstar_header_decode_device(dibits: jax.Array, ch: jax.Array,
                               pos: jax.Array) -> jax.Array:
    """F header hits (``pos`` = sync start) → [F, 41] header octets
    (descramble → de-interleave → batched K=3 Viterbi → LSB-first
    pack, identical to DstarDecoder._header)."""
    from dsdneo_tpu.fec.device import conv_k3_decode_batch
    scram, inv, _ = _dstar_tables()
    bits = _gather_bits(dibits, ch, pos, 24 + np.arange(660))
    dei = (bits ^ jnp.asarray(scram))[:, jnp.asarray(inv)]
    info = conv_k3_decode_batch(dei)              # [F, 330]
    return _pack(info[:, :328], _LSB_W)           # [F, 41]


@jax.jit
def dstar_voice_decode_device(dibits: jax.Array, ch: jax.Array,
                              pos: jax.Array) -> jax.Array:
    """F voice-superframe hits → uint8 blob [F, 417]: 60 descrambled
    slow-data bytes | 21×72 raw AMBE bits packed MSB-first (189) |
    21×49 ECC-decoded AMBE parameter bits (each frame padded to 7
    bytes, 147) | 21 per-frame ECC error counts."""
    from dsdneo_tpu.fec.device import dstar_ambe_ecc_batch
    _, _, sd_scram = _dstar_tables()
    voff, doff = _voice_offsets()
    vbits = _gather_bits(dibits, ch, pos, voff)   # [F, 21, 72]
    sd = _gather_bits(dibits, ch, pos, doff).reshape(-1, 480) \
        ^ jnp.asarray(sd_scram)
    # host packing (reverse bit order, MSB walk, reversed byte store)
    # collapses to LSB-first bytes in stream order
    sd_bytes = _pack(sd, _LSB_W)                  # [F, 60]
    vbytes = _pack(vbits.reshape(-1, 21 * 72), _MSB_W)
    ambe, errs = dstar_ambe_ecc_batch(vbits.reshape(-1, 72))
    ambe56 = jnp.concatenate(
        [ambe, jnp.zeros((ambe.shape[0], 7), jnp.uint8)], axis=1)
    abytes = _pack(ambe56, _MSB_W).reshape(-1, 21 * 7)
    ebytes = jnp.minimum(errs, 255).astype(jnp.uint8).reshape(-1, 21)
    return jnp.concatenate([sd_bytes, vbytes, abytes, ebytes], axis=1)


class BatchedDstarPipeline:
    """Drives the batched D-STAR chain over one [C, B] block."""

    SYNC_NAMES = ("+D-STAR", "+D-STAR HD")
    SYNC_TOPK = 64              # ~7 superframes + header per 3 s block

    CHAIN_TOL = 2               # ± dibits for the ±2016 partner check
    HD_SOLO_SCORE = 0.68        # header emit floor when its CRC fails

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.55, pcm_fmt: str = "f16"):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        from dsdneo_tpu.protocol.base import DecoderContext
        self.C = C
        self.fs = fs
        self.mode = MODES["dstar"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        self.ctxs = [DecoderContext() for _ in range(C)]
        self._active = [False] * C    # per-block voicing activity
        self._jits = {}

    # -- front end: gated demod + clipped per-pattern correlation ----------
    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def frontend_dispatch(self, iq):
        from dsdneo_tpu.engine.demod import gated_frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("dstar", B, n_sym)
        fn = self._jits.get(key)
        if fn is None:
            taps = jnp.asarray(self.taps)
            names = self.SYNC_NAMES
            _, _, _, n_max_pat = _sync_kernel(names)
            n_corr = n_sym - n_max_pat + 1
            k_cand = min(self.SYNC_TOPK, n_corr)
            sps = self.sps

            @jax.jit
            def fn(x):
                dibits, soft = gated_frontend_step(
                    x, taps, sps, n_sym, self.mode.four_level)
                sc = correlate_syncs_device(
                    jnp.clip(soft, -3.5, 3.5), names)   # [C, P, n_corr]
                flat = sc.reshape(sc.shape[0], -1)      # pat-major
                vals, idx = jax.lax.top_k(flat, k_cand)
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return dibits, jnp.concatenate(
                    [u8(idx.astype(jnp.uint32)), vq], axis=1)
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return dibits_dev, blob_dev, n_sym

    def frontend_finish(self, fe):
        dibits_dev, blob_dev, n_sym = fe
        blob = np.asarray(blob_dev)
        _, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        n_corr = n_sym - n_max + 1
        k_cand = min(self.SYNC_TOPK, n_corr)
        flat = blob[:, :4 * k_cand].copy().view(np.uint32).astype(np.int64)
        vq = blob[:, 4 * k_cand:5 * k_cand]
        pat = (flat // n_corr).astype(np.int32)         # 0=voice, 1=hd
        pos = (flat % n_corr).astype(np.int64)
        return dibits_dev, pat, pos, vq, n_sym

    def pick_frames(self, pat, pos, vq, n_sym: int):
        """Threshold pre-filter → ±8 local-max cluster refinement →
        voice superframe-chain gate (partner sync at ±2016±2) →
        extent-respecting greedy schedule.  Returns (ch, pos, kind,
        score) arrays; a ±1 sync offset garbles the interleave, hence
        the cluster refinement."""
        extent = {0: VOICE_EXTENT, 1: HEADER_EXTENT}
        acc_c, acc_t, acc_k, acc_s = [], [], [], []
        for c in range(pat.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(pos[c][ok], kind="stable")
            positions = pos[c][ok][order]
            kinds = pat[c][ok][order]
            scores = sc[ok][order]
            # cluster refinement: one best hit per ±8-dibit window
            cand = []                       # (t, kind, score)
            j = 0
            while j < len(positions):
                t = int(positions[j])
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                cand.append((int(positions[w]), int(kinds[w]),
                             float(scores[w])))
                j = k
            # voice chain gate: partner voice sync at ±2016 (±tol)
            vpos = np.asarray([t for t, kk, _ in cand if kk == 0])
            kept = []
            for t, kk, s in cand:
                if kk == 0:
                    d = np.abs(np.abs(vpos - t) - VOICE_EXTENT)
                    if not (d <= self.CHAIN_TOL).any():
                        continue
                kept.append((t, kk, s))
            # greedy schedule: frames must not overlap
            last_end = -10 ** 9
            for t, kk, s in kept:
                if t < last_end or t + extent[kk] > n_sym:
                    continue
                last_end = t + extent[kk]
                acc_c.append(c)
                acc_t.append(t)
                acc_k.append(kk)
                acc_s.append(s)
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_k, np.int32), np.asarray(acc_s, np.float32))

    # -- full block ---------------------------------------------------------
    def decode_block_events(self, iq) -> int:
        """One [C, B] block end to end; events land in
        ``self.ctxs[c].events``.  Returns accepted frames (both kinds)."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe5) -> int:
        """Second fleet-pipeline stage (see FleetMonitor.decode_block)."""
        dibits_dev, pat, pos, vq, n_sym = fe5
        ac, at, ak, ascore = self.pick_frames(pat, pos, vq, n_sym)
        self._active = [False] * self.C
        hits = list(zip(ac, at, ak, ascore))
        blobs = {}
        for kind, fn in ((0, dstar_voice_decode_device),
                         (1, dstar_header_decode_device)):
            sel = [(c, t) for c, t, k, _ in hits if k == kind]
            if not sel:
                continue
            F = len(sel)
            Fp = -(-F // 8) * 8
            cc = np.full(Fp, self.C, dtype=np.int32)
            tt = np.zeros(Fp, dtype=np.int32)
            cc[:F] = [s[0] for s in sel]
            tt[:F] = [s[1] for s in sel]
            blobs[kind] = np.asarray(
                fn(dibits_dev, jnp.asarray(cc), jnp.asarray(tt)))[:F]
        counters = {0: 0, 1: 0}
        n_acc = 0
        for c, t, k, s in hits:
            rec = blobs[k][counters[k]]
            counters[k] += 1
            n_acc += self._frame(int(c), int(t), int(k), float(s), rec)
        return n_acc

    def _frame(self, c: int, t: int, kind: int, score: float,
               rec: np.ndarray) -> int:
        from dsdneo_tpu.protocol.dstar.decoder import (header_line,
                                                       slow_data_line)
        ctx = self.ctxs[c]
        if kind == 1:
            line, crc_ok, fields = header_line(rec, ctx)
            if not crc_ok and score < self.HD_SOLO_SCORE:
                return 0            # weak hit AND bad CRC: junk
            ctx.emit(f"Sync: +D-STAR HD HEADER  {line}", "dstar", t,
                     **fields)
            return 1
        line = slow_data_line(rec[:60], ctx)
        voice = np.unpackbits(rec[60:249]).reshape(21, 72)
        ambe = np.unpackbits(rec[249:396]).reshape(21, 56)[:, :49]
        errs = rec[396:417].astype(np.int32)
        # voicing/activity field (ambe2400.voicing_activity, bits 42:46
        # LSB-first): any clean frame with speech marks the channel hot
        vo = (ambe[:, 42] | (ambe[:, 43] << 1) | (ambe[:, 44] << 2)
              | (ambe[:, 45] << 3))
        if bool(((errs == 0) & (vo > 0)).any()):
            self._active[c] = True
        ctx.emit(f"Sync: +D-STAR VOICE  {line}", "dstar", t, voice=voice,
                 ambe49=ambe, ambe_errs=errs)
        return 1

    def channel_state(self, c: int) -> str:
        """Fleet channel-grid state: 'voice' while the last block
        carried a superframe with active voicing, else 'idle'."""
        return "voice" if self._active[c] else "idle"

    def events(self, c: int):
        return self.ctxs[c].events

    def decode_block(self, iq) -> np.ndarray:
        """FleetMonitor voice-group surface: D-STAR has no synthesized
        PCM (raw AMBE-2400), so this returns [C, 0] after decoding the
        block's events."""
        self.decode_block_events(iq)
        return np.zeros((self.C, 0), np.float32)

    def decode_from_frontend(self, fe5) -> np.ndarray:
        """Staged voice surface for the fleet pipeline."""
        self.events_from_frontend(fe5)
        return np.zeros((self.C, 0), np.float32)

    @staticmethod
    def fetch_pcm(handle) -> np.ndarray:
        return handle

    # parity hook: raw per-frame records without event emission
    def decode_block_records(self, iq):
        dibits_dev, pat, pos, vq, n_sym = self.frontend_sync_device(iq)
        ac, at, ak, _sc = self.pick_frames(pat, pos, vq, n_sym)
        out = []
        for c, t, k in zip(ac, at, ak):
            fn = dstar_header_decode_device if k else \
                dstar_voice_decode_device
            rec = np.asarray(fn(dibits_dev, jnp.asarray([c]),
                                jnp.asarray([t])))[0]
            out.append((int(c), int(t), int(k), rec))
        return out
