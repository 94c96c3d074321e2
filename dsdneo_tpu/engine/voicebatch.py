"""Batched many-channel P25p1 voice pipeline: I/Q → PCM on device.

The production-scale path the headline benchmark measures.  Per step a
``[C, B]`` block of channels runs:

  1. front end (channel LPF → discriminator → timing → slicing) —
     dsdneo_tpu.engine.batched.frontend_step;
  2. frame-sync matched filter on device (one conv over [C, T] soft
     symbols; host does only thresholded peak picking) —
     the device half of src/dsp/dsd_frame_sync.c:3102;
  3. batched BCH(63,16) NID decode (codebook matmul) —
     src/protocol/p25/phase1/p25p1_check_nid.cpp;
  4. batched IMBE voice-frame ECC for every LDU voice frame in the
     block (fec.device.imbe_ecc_batch);
  5. vectorized IMBE dequantization with per-channel prediction state
     (vocoder.batch.BatchedImbeDecoder);
  6. batched harmonic synthesis on device (vocoder.synth) with
     per-channel phase continuity via vmap.

Status symbols are stripped by precomputed index maps; everything
data-dependent (peak picking, window indexing) is vectorized numpy.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.fec import blockcodes, device as fdev
from dsdneo_tpu.symbols import framesync
from dsdneo_tpu.vocoder.batch import MAX_L, BatchedImbeDecoder


# -- device sync correlation ------------------------------------------------
@lru_cache(maxsize=None)
def _sync_kernel(names: tuple[str, ...]):
    """numpy only — this cache is shared between jit traces and host
    code, so it must never hold traced values."""
    defs = [d for d in framesync.SYNC_DEFS if d.name in names]
    n_max = max(len(d.pattern) for d in defs)
    k = np.zeros((len(defs), 1, n_max), dtype=np.float32)
    norm = np.zeros(len(defs), dtype=np.float32)
    for i, d in enumerate(defs):
        k[i, 0, :len(d.levels)] = d.levels
        norm[i] = 1.0 / (9.0 * len(d.levels))
    return defs, k, norm, n_max


@partial(jax.jit, static_argnames=("names",))
def correlate_syncs_device(soft: jax.Array, names: tuple[str, ...]
                           ) -> jax.Array:
    """[C, T] soft symbols → [C, P, T-n+1] normalized correlations
    (device conv; identical to framesync.correlate_syncs per pattern)."""
    _, kern, norm, n_max = _sync_kernel(names)
    out = jax.lax.conv_general_dilated(
        soft[:, None, :], jnp.asarray(kern), window_strides=(1,),
        padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return out * jnp.asarray(norm)[None, :, None]


# -- P25p1 LDU layout -------------------------------------------------------
def _ldu_imbe_offsets() -> list[int]:
    """Data-dibit offset (post status-strip, from the end of the NID) of
    each of the 9 IMBE frames inside an LDU (mirrors phase1._ldu1 /
    _ldu2 read order: 72-dibit frames with 20-dibit hexword blocks after
    frames 1-6 and the 16-dibit LSD after frame 7)."""
    offs, at = [], 0
    for seg in range(9):
        offs.append(at)
        at += 72
        if 1 <= seg <= 6:
            at += 20
        elif seg == 7:
            at += 16
    return offs


LDU_IMBE_OFFSETS = _ldu_imbe_offsets()
LDU_DATA_DIBITS = 784


@lru_cache(maxsize=None)
def _status_strip_map(rel_start: int, count: int) -> np.ndarray:
    """Absolute stream offsets (relative to frame start) of the first
    ``count`` DATA dibits starting at data-offset 0 of a reader
    positioned ``rel_start`` dibits after the frame start, skipping
    status dibits at positions ≡ 35 (mod 36)."""
    out = np.zeros(count, dtype=np.int64)
    q = rel_start
    for i in range(count):
        while q % 36 == 35:
            q += 1
        out[i] = q
        q += 1
    return out


class BatchedP25VoicePipeline:
    """Drives the batched chain over one [C, B] block (one-shot)."""

    # both polarities correlate (matching the event hunter's candidate
    # competition); only positive hits are voice-decoded here — inverted
    # channels are handled by the event-driven path
    SYNC_NAMES = ("+P25p1", "-P25p1")
    # sync candidates fetched per channel per block (device top-k);
    # a 3 s block carries ~17 LDU syncs + peak-shoulder neighbors
    SYNC_TOPK = 512
    # candidates NID-decoded on device alongside the sync correlation
    # (top-K by score); anything beyond falls back to a second small
    # device dispatch in pick_ldus — nothing is silently dropped
    NID_TOPK = 48

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, cqpsk: bool = False,
                 pcm_fmt: str = "f16"):
        from dsdneo_tpu.engine.modes import MODES
        from dsdneo_tpu.dsp import firdes
        self.C = C
        self.fs = fs
        self.mode = MODES["p25p1"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        # cqpsk=True swaps the C4FM front end for the feed-forward
        # LSM/CQPSK chain (dsp.cqpsk: 4th-power CFO + RRC + O&M +
        # differential phasor); everything after the soft symbols —
        # sync, NID, LDU gather, voice decode — is modulation-agnostic
        self.cqpsk = cqpsk
        self.imbe_dec = BatchedImbeDecoder(C)
        self.bch = blockcodes.bch_63_16()
        # "mulaw" = G.711 wire format (engine.dmrbatch): halves the
        # PCM transfer at the telephony-standard ~38 dB SNDR
        self.pcm_fmt = pcm_fmt

    def _front(self, x, n_sym: int):
        """Traced front end: [C, B(, 2)] → (dibits, soft, power)."""
        from dsdneo_tpu.engine.batched import frontend_step
        if not self.cqpsk:
            return frontend_step(x, self.taps, self.sps, n_sym,
                                 self.mode.four_level)
        from dsdneo_tpu.dsp.cqpsk import demod_cqpsk
        xc = jax.lax.complex(x[..., 0], x[..., 1]) if x.ndim == 3 else x
        soft, _cfo = demod_cqpsk(xc, self.fs,
                                 float(self.mode.symbol_rate),
                                 n_sym=n_sym)
        neg = soft < 0.0
        outer = jnp.abs(soft) > 2.0
        dibits = jnp.where(neg, jnp.where(outer, 3, 2),
                           jnp.where(outer, 1, 0)).astype(jnp.uint8)
        power = jnp.mean(jnp.abs(xc) ** 2, axis=-1)
        return dibits, soft, power

    def frontend_sync(self, iq):
        """Fused device step: front end + sync matched filter in ONE
        dispatch, fetching only compact arrays (dibits uint8, per-
        position best score float16 + best pattern uint8): the [C, T]
        float32 soft symbols never leave the device."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("fs", B, n_sym, self.cqpsk)
        if not hasattr(self, "_frontend_jits"):
            self._frontend_jits = {}
        fn = self._frontend_jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES

            defs, _, _, n_max_pat = _sync_kernel(self.SYNC_NAMES)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            n_pat = len(defs[0].pattern)
            nid_strip = _status_strip_map(n_pat, 32)       # [32] offsets
            bch_pm = self.bch.pm.astype(np.float32)        # [65536, 63]

            @jax.jit
            def fn(x):
                dibits, soft, power = self._front(x, n_sym)
                sc = correlate_syncs_device(soft, names)   # [C, P, T']
                best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
                bs = jnp.max(sc, axis=1)                   # [C, T']
                # only the top-K candidate positions per channel leave
                # the device (the picker thresholds at ~0.62; anything
                # beyond K sync-like peaks per block is pathological);
                # scores quantized to 1/128 steps, far below the
                # pattern-correlation noise floor
                vals, idx = jax.lax.top_k(bs, k_cand)      # [C, K]
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                dq = jnp.take_along_axis(best_def, idx, axis=1)
                # NID BCH(63,16) ML decode for the strongest candidates,
                # on device: the positions are already known here, and
                # the [C·Kn, 63]×[63, 65536] codebook matmul takes bf16
                # operands on purpose: inputs are ±1 and every score is
                # a sum of at most 63 of them, exact in bf16 products
                # with f32 accumulation — saves the hunt a third device
                # round trip.
                # Kn is capped to bound the [C·Kn, 65536] score tile.
                k_nid = min(self.NID_TOPK, k_cand)
                idx_n = idx[:, :k_nid]
                Cn = dibits.shape[0]
                gpos = jnp.clip(idx_n[:, :, None] + jnp.asarray(nid_strip),
                                0, dibits.shape[1] - 1)     # [C, Kn, 32]
                nd = dibits[jnp.arange(Cn)[:, None, None], gpos]
                b64 = jnp.stack([(nd >> 1) & 1, nd & 1], axis=-1
                                ).reshape(Cn, k_nid, 64)
                s = (1.0 - 2.0 * b64[..., :63].astype(jnp.float32)
                     ).astype(jnp.bfloat16)
                msg = jnp.argmax(
                    s.reshape(-1, 63) @ jnp.asarray(bch_pm).astype(
                        jnp.bfloat16).T, axis=-1
                    ).astype(jnp.uint16).reshape(Cn, k_nid)  # [C, Kn]
                # pack dibits 4-per-byte: a quarter of the fetched bytes
                pad = (-dibits.shape[1]) % 4
                dp = jnp.pad(dibits, ((0, 0), (0, pad)))
                dp = (dp[:, 0::4] << 6) | (dp[:, 1::4] << 4) | \
                     (dp[:, 2::4] << 2) | dp[:, 3::4]
                # ONE fetched buffer: one host↔device exchange
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                return jnp.concatenate(
                    [dp, u8(idx.astype(jnp.uint16)), vq, dq, u8(msg)],
                    axis=1)
            self._frontend_jits[key] = fn
        blob = np.asarray(fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq)))
        # unpack on host
        T = n_sym
        C = blob.shape[0]
        defs, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        Tp = n_sym - n_max + 1
        k_cand = min(self.SYNC_TOPK, Tp)
        k_nid = min(self.NID_TOPK, k_cand)
        n_dp = (n_sym + 3) // 4
        o = 0
        dp = blob[:, o:o + n_dp]; o += n_dp
        idx = blob[:, o:o + 2 * k_cand].copy().view(np.uint16
                                                    ).astype(np.int64)
        o += 2 * k_cand
        vq = blob[:, o:o + k_cand]; o += k_cand
        dq = blob[:, o:o + k_cand]; o += k_cand
        msg = blob[:, o:o + 2 * k_nid].copy().view(np.uint16)
        dib = np.zeros((C, n_dp * 4), dtype=np.uint8)
        dib[:, 0::4] = (dp >> 6) & 3
        dib[:, 1::4] = (dp >> 4) & 3
        dib[:, 2::4] = (dp >> 2) & 3
        dib[:, 3::4] = dp & 3
        # scatter the sparse candidates back to dense arrays (scores
        # default 0.0 = below any threshold) so the greedy picker sees
        # exactly what it would on the full score arrays
        bs = np.zeros((C, Tp), dtype=np.float32)
        bd = np.zeros((C, Tp), dtype=np.uint8)
        # 0xFFFF = "not NID-decoded on device" (hunt falls back)
        nm = np.full((C, Tp), 0xFFFF, dtype=np.uint16)
        rows = np.arange(C)[:, None]
        bs[rows, idx] = vq.astype(np.float32) / 127.0
        bd[rows, idx] = dq
        nm[rows, idx[:, :k_nid]] = msg
        return dib[:, :T], bd, bs, nm

    def frontend_dispatch(self, iq):
        """Queue the frontend+sync+NID device program WITHOUT fetching
        the candidate blob: returns (dibits_dev, blob_dev, n_sym)
        handles.  The deep-pipelined driver dispatches block N+1's
        frontend before fetching block N's blob, so the exchange and
        the next block's device compute overlap
        (frontend_finish completes the exchange)."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("fsd", B, n_sym, self.cqpsk)
        if not hasattr(self, "_frontend_jits"):
            self._frontend_jits = {}
        fn = self._frontend_jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(self.SYNC_NAMES)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            n_pat = len(defs[0].pattern)
            nid_strip = _status_strip_map(n_pat, 32)
            bch_pm = self.bch.pm.astype(np.float32)

            @jax.jit
            def fn(x):
                dibits, soft, power = self._front(x, n_sym)
                sc = correlate_syncs_device(soft, names)
                best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
                bs = jnp.max(sc, axis=1)
                vals, idx = jax.lax.top_k(bs, k_cand)
                vq = jnp.clip(vals * 127.0, 0, 255).astype(jnp.uint8)
                dq = jnp.take_along_axis(best_def, idx, axis=1)
                k_nid = min(self.NID_TOPK, k_cand)
                idx_n = idx[:, :k_nid]
                Cn = dibits.shape[0]
                gpos = jnp.clip(idx_n[:, :, None] + jnp.asarray(nid_strip),
                                0, dibits.shape[1] - 1)
                nd = dibits[jnp.arange(Cn)[:, None, None], gpos]
                b64 = jnp.stack([(nd >> 1) & 1, nd & 1], axis=-1
                                ).reshape(Cn, k_nid, 64)
                s = (1.0 - 2.0 * b64[..., :63].astype(jnp.float32)
                     ).astype(jnp.bfloat16)
                msg = jnp.argmax(
                    s.reshape(-1, 63) @ jnp.asarray(bch_pm).astype(
                        jnp.bfloat16).T, axis=-1
                    ).astype(jnp.uint16).reshape(Cn, k_nid)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                blob = jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq, dq, u8(msg)], axis=1)
                return dibits, blob
            self._frontend_jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return dibits_dev, blob_dev, n_sym

    def frontend_finish(self, fe, cofetch=None):
        """Fetch + parse the candidate blob of a frontend_dispatch."""
        dibits_dev, blob_dev, n_sym = fe
        if cofetch is not None:
            # one device-to-host exchange for the candidate blob + the
            # caller's extra device arrays (see TrunkedFleet.step)
            import jax
            blob, _co = jax.device_get((blob_dev, cofetch))
        else:
            blob, _co = np.asarray(blob_dev), None
        defs, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        Tp = n_sym - n_max + 1
        k_cand = min(self.SYNC_TOPK, Tp)
        k_nid = min(self.NID_TOPK, k_cand)
        o = 0
        idx = blob[:, o:o + 2 * k_cand].copy().view(np.uint16
                                                    ).astype(np.int64)
        o += 2 * k_cand
        vq = blob[:, o:o + k_cand]; o += k_cand
        dq = blob[:, o:o + k_cand]; o += k_cand
        msg = blob[:, o:o + 2 * k_nid].copy().view(np.uint16)
        out = (dibits_dev, idx, vq, dq, msg, n_sym)
        return (out, _co) if cofetch is not None else out

    def frontend_sync_device(self, iq):
        """frontend_sync variant for the device-resident fast path: the
        [C, T] dibit array STAYS on device (returned as a jax handle for
        voice_decode_gather); only the compact candidate blob — top-K
        positions, quantized scores, pattern ids, NID messages — leaves
        the device (~50 KB vs ~700 KB with the packed dibits)."""
        return self.frontend_finish(self.frontend_dispatch(iq))

    def _peak_hits(self, idx, vq, dq):
        """Pass 1 of the sparse picker: per-channel greedy peak walk over
        the candidate blob — sorted by position, refine to the local
        maximum within 8 positions, jump a pattern length (the same
        semantics as framesync.pick_syncs_from_best).  Returns
        [(channel, position, def_index)] without any DUID decision."""
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        hits = []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            positions = idx[c][ok]
            order = np.argsort(positions, kind="stable")
            # plain lists: the greedy walk is Python-loop-bound at fleet
            # scale, and list indexing is ~4x cheaper than np scalars
            positions = positions[order].tolist()
            scores = sc[ok][order].tolist()
            pdefs = dq[c][ok][order].tolist()
            plens = [len(d.pattern) for d in defs]
            pos = 0
            n = len(positions)
            for j in range(n):
                t = positions[j]
                if t < pos:
                    continue
                w = j
                for j2 in range(j + 1, n):
                    if positions[j2] >= t + 8:
                        break
                    if scores[j2] > scores[w]:
                        w = j2
                p = positions[w]
                pos = p + plens[pdefs[w]]
                hits.append((c, p, pdefs[w]))
        return hits

    def nid_decode_positions(self, dibits_dev, ch: np.ndarray,
                             pos: np.ndarray) -> np.ndarray:
        """Second-chance device NID decode for sync hits outside the
        fused dispatch's top-K-by-score set: upload (channel, position)
        pairs, gather the 32 status-stripped NID dibits from the
        device-resident dibit array, BCH(63,16) ML decode, fetch the
        [H] uint16 messages.  Keeps pick_ldus lossless on channels with
        pathological candidate counts (>NID_TOPK sync-quality peaks —
        co-channel interference), matching find_voice_frames_best's
        host fallback."""
        H = ch.shape[0]
        if H == 0:
            return np.zeros(0, dtype=np.uint16)
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        n_pat = len(defs[0].pattern)
        nid_strip = _status_strip_map(n_pat, 32).astype(np.int32)
        bch_pm = self.bch.pm.astype(np.float32)
        if not hasattr(self, "_nid_jit"):
            @jax.jit
            def _nid_fn(dibits, chv, posv):
                Tn = dibits.shape[1]
                gp = jnp.clip(posv[:, None] + jnp.asarray(nid_strip),
                              0, Tn - 1)
                chc = jnp.minimum(chv, dibits.shape[0] - 1)
                nd = dibits[chc[:, None], gp]                 # [H, 32]
                b64 = jnp.stack([(nd >> 1) & 1, nd & 1], axis=-1
                                ).reshape(nd.shape[0], 64)
                s = (1.0 - 2.0 * b64[:, :63].astype(jnp.float32)
                     ).astype(jnp.bfloat16)
                return jnp.argmax(
                    s @ jnp.asarray(bch_pm).astype(jnp.bfloat16).T,
                    axis=-1).astype(jnp.uint16)
            self._nid_jit = _nid_fn
        Hp = -(-H // 64) * 64                  # shape bucket
        chp = np.zeros(Hp, dtype=np.int32)
        chp[:H] = ch
        posp = np.zeros(Hp, dtype=np.int32)
        posp[:H] = pos
        out = np.asarray(self._nid_jit(dibits_dev, jnp.asarray(chp),
                                       jnp.asarray(posp)))
        return out[:H]

    def pick_frames_by_duid(self, idx, vq, dq, msg, T: int,
                            duids: tuple[int, ...], need: int,
                            frames_per_hit: int, dibits_dev=None):
        """Sparse greedy sync picking + frame acceptance from the
        candidate blob: peak walk (pass 1), NID lookup — device top-K
        map with a second-dispatch fallback for uncovered hits when
        ``dibits_dev`` is given — then accept hits whose DUID is in
        ``duids`` outside any previously accepted frame extent."""
        k_nid = msg.shape[1]
        hits = self._peak_hits(idx, vq, dq)
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        # vectorized NID lookup (replaces a C*k_nid-entry Python dict):
        # flat (channel*T + position) keys into the device NID map via
        # one sorted searchsorted pass over all hits
        hmsg = []
        if hits:
            kk = min(k_nid, idx.shape[1])
            Tbig = int(idx.max()) + 2 if idx.size else 1
            keys = (np.arange(idx.shape[0], dtype=np.int64)[:, None]
                    * Tbig + idx[:, :kk]).ravel()
            vals = msg[:, :kk].ravel()
            srt = np.argsort(keys, kind="stable")
            keys_s, vals_s = keys[srt], vals[srt]
            hk = np.asarray([h[0] * Tbig + h[1] for h in hits],
                            dtype=np.int64)
            ji = np.clip(np.searchsorted(keys_s, hk), 0, len(keys_s) - 1)
            found = keys_s[ji] == hk
            hmsg = np.where(found, vals_s[ji].astype(np.int64),
                            -1).tolist()
        pending = [h for h, (c, p, di) in enumerate(hits)
                   if hmsg[h] < 0 and not defs[di].inverted
                   and p + need < T]
        if pending and dibits_dev is not None:
            pc = np.asarray([hits[h][0] for h in pending], dtype=np.int32)
            pp = np.asarray([hits[h][1] for h in pending], dtype=np.int32)
            extra = self.nid_decode_positions(dibits_dev, pc, pp)
            for h, m in zip(pending, extra):
                hmsg[h] = int(m)
        acc_c, acc_t, acc_m, fch, forder = [], [], [], [], []
        frame_end = {}
        n_order = {}
        for h, (c, p, di) in enumerate(hits):
            if defs[di].inverted or p + need >= T:
                continue
            if p < frame_end.get(c, -1):
                continue
            m = hmsg[h] if hmsg[h] >= 0 else 0xFFFF
            if (m & 0xF) not in duids:
                continue
            frame_end[c] = p + need
            base = n_order.get(c, 0)
            acc_c.append(c)
            acc_t.append(p)
            acc_m.append(m)
            fch.extend([c] * frames_per_hit)
            forder.extend(range(base, base + frames_per_hit))
            n_order[c] = base + frames_per_hit
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_m, np.int64),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    def pick_ldus(self, idx, vq, dq, msg, T: int, dibits_dev=None):
        """LDU picking from the candidate blob: accept DUID 5/10 hits
        outside any previous LDU (9 IMBE frames each).  NID comes from
        the device's top-K-by-score set, with a device-dispatch
        fallback for uncovered hits when ``dibits_dev`` is passed."""
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        n_pat = len(defs[0].pattern)
        strip = _status_strip_map(n_pat, 32 + LDU_DATA_DIBITS)
        need = int(strip[-1]) + 1
        ac, at, _am, fch, forder = self.pick_frames_by_duid(
            idx, vq, dq, msg, T, (5, 10), need, 9, dibits_dev)
        return ac, at, fch, forder

    def frontend(self, iq: np.ndarray):
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = (B, n_sym)
        fn = self._frontend_jits.get(key) if hasattr(self, "_frontend_jits") \
            else None
        if fn is None:
            if not hasattr(self, "_frontend_jits"):
                self._frontend_jits = {}
            taps = self.taps

            @jax.jit
            def fn(x):
                return frontend_step(x, taps, self.sps, n_sym,
                                     self.mode.four_level)
            self._frontend_jits[key] = fn
        return fn(jnp.asarray(iq))

    def find_voice_frames(self, dibits: np.ndarray, soft: np.ndarray):
        """Hunt from full soft symbols (test/parity path): device
        correlation then the shared picking logic."""
        scores = np.asarray(correlate_syncs_device(
            jnp.asarray(soft), self.SYNC_NAMES))                # [C, P, T']
        best_def = np.argmax(scores, axis=1).astype(np.uint8)
        best_score = np.max(scores, axis=1)
        return self.find_voice_frames_best(dibits, best_def, best_score,
                                           soft.shape[1])

    def find_voice_frames_best(self, dibits: np.ndarray,
                               best_def: np.ndarray, best_score: np.ndarray,
                               T: int, nid_msg: np.ndarray | None = None):
        """Hunt from per-position (best pattern, best score) arrays:
        the same greedy peak picking as the event-driven hunter, batched
        NID decode; returns (frames144 [F, 144], frame_channel [F],
        frame_order [F]) for every LDU voice frame."""
        C = dibits.shape[0]
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        n_pat = len(defs[0].pattern)

        # one strip map covers NID (32 data dibits) + the whole LDU,
        # relative to the frame start (the sync position)
        strip = _status_strip_map(n_pat, 32 + LDU_DATA_DIBITS)
        need = int(strip[-1]) + 1
        frames, fch, forder = [], [], []

        nid_meta = []                           # (channel, sync pos)
        for c in range(C):
            hits = framesync.pick_syncs_from_best(
                best_def[c], best_score[c].astype(np.float32), defs,
                self.threshold, limit=T)
            for h in hits:
                t = h.pos
                if h.sync.inverted or t + need >= T:
                    continue
                nid_meta.append((c, t))
        if not nid_meta:
            return (np.zeros((0, 144), dtype=np.uint8),
                    np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))

        # NID messages: either precomputed on device alongside the sync
        # correlation (frontend_sync's fast path) or decoded here
        mc = np.asarray([c for c, _ in nid_meta], dtype=np.int64)
        mt = np.asarray([t for _, t in nid_meta], dtype=np.int64)
        if nid_msg is not None:
            raw = nid_msg[mc, mt].astype(np.int64)
            duid = raw & 0xF
            unk = np.flatnonzero(raw == 0xFFFF)
            if unk.size:
                # hits outside the device NID set (beyond the top-Kn
                # candidates): decode just those in one small batch
                nid_d = dibits[mc[unk, None],
                               mt[unk, None] + strip[None, :32]
                               ].astype(np.int64)
                bits64 = np.zeros((unk.size, 64), dtype=np.uint8)
                bits64[:, 0::2] = (nid_d >> 1) & 1
                bits64[:, 1::2] = nid_d & 1
                m, _ = fdev.bch_63_16_batch(bits64[:, :63])
                duid[unk] = np.asarray(m) & 0xF
        else:
            nid_d = dibits[mc[:, None], mt[:, None] + strip[None, :32]
                           ].astype(np.int64)                    # [H, 32]
            bits64 = np.zeros((nid_d.shape[0], 64), dtype=np.uint8)
            bits64[:, 0::2] = (nid_d >> 1) & 1
            bits64[:, 1::2] = nid_d & 1
            m, errs = fdev.bch_63_16_batch(bits64[:, :63])
            duid = np.asarray(m) & 0xF

        # accept LDU1/LDU2 hits outside any previously accepted LDU
        order_per_ch = {c: 0 for c in range(C)}
        ldu_end = {c: -1 for c in range(C)}
        acc_c, acc_t = [], []
        fch, forder = [], []
        for h in range(len(nid_meta)):
            c, t = int(mc[h]), int(mt[h])
            if t < ldu_end[c] or int(duid[h]) not in (5, 10):
                continue
            ldu_end[c] = t + need
            acc_c.append(c)
            acc_t.append(t)
            fch.extend([c] * 9)
            forder.extend(range(order_per_ch[c], order_per_ch[c] + 9))
            order_per_ch[c] += 9
        if not acc_c:
            return (np.zeros((0, 144), dtype=np.uint8),
                    np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))

        # one gather for all voice frames: [L, 9, 72] dibits → [F, 144]
        ac = np.asarray(acc_c, dtype=np.int64)
        at = np.asarray(acc_t, dtype=np.int64)
        offs = np.stack([strip[32 + o:32 + o + 72]
                         for o in LDU_IMBE_OFFSETS])             # [9, 72]
        dd = dibits[ac[:, None, None],
                    at[:, None, None] + offs[None]].astype(np.uint8)
        dd = dd.reshape(-1, 72)                                  # [F, 72]
        frames = np.zeros((dd.shape[0], 144), dtype=np.uint8)
        frames[:, 0::2] = (dd >> 1) & 1
        frames[:, 1::2] = dd & 1
        return (frames, np.asarray(fch, dtype=np.int64),
                np.asarray(forder, dtype=np.int64))

    def decode_block(self, iq) -> np.ndarray:
        """Full chain for one [C, B] block → [C, n_frames*160] PCM."""
        return self.fetch_pcm(self.decode_block_async(iq))

    def decode_block_async(self, iq):
        """Dispatch the full chain WITHOUT fetching the PCM: returns the
        device-resident [C, T, 160] f16 array.  The streaming consumer
        overlaps this block's device compute with the previous block's
        PCM DMA (fetch_pcm) — JAX async dispatch queues the program and
        returns immediately, so
            h = pipe.decode_block_async(next_block)
            pcm = pipe.fetch_pcm(prev_handle)     # DMA ∥ compute
        is the production steady-state shape (the reference's demod
        thread/output-ring decoupling, rtl_sdr_fm.cpp:296).

        ``iq`` may be host numpy or an already-device-resident array
        (jax.device_put) — production feeds pre-transfer blocks so the
        infeed overlaps compute.  The dibit array never leaves the
        device: the host sees only the ~50 KB candidate blob, picks the
        LDU list, and uploads the accepted positions; frame gather +
        ECC + dequantization + prediction + synthesis run as ONE device
        dispatch (vocoder.device.voice_decode_gather); only the f16 PCM
        comes back."""
        return self.decode_from_frontend(
            self.frontend_finish(self.frontend_dispatch(iq)))

    def decode_from_frontend(self, fe6):
        """Pick LDUs from a finished frontend exchange and dispatch the
        voice gather program (async): the second pipeline stage of the
        deep-pipelined driver (see bench.bench_full_chain)."""
        from dsdneo_tpu.vocoder.device import voice_decode_gather
        dibits_dev, idx, vq, dq, msg, n_sym = fe6
        ac, at, fch, forder = self.pick_ldus(idx, vq, dq, msg, n_sym,
                                             dibits_dev=dibits_dev)
        L = ac.shape[0]
        if L == 0:
            return np.zeros((self.C, 0), dtype=np.float32)
        n_steps = int(forder.max()) + 1
        # pad to shape buckets so repeated blocks reuse the compiled
        # program (LDUs to 32s -> frames to 288s, steps to multiples
        # of 27)
        Lp = -(-L // 32) * 32
        Tp = -(-n_steps // 27) * 27
        acp = np.full(Lp, self.C, dtype=np.int32)    # pad row C: dropped
        acp[:L] = ac
        atp = np.zeros(Lp, dtype=np.int32)
        atp[:L] = at
        fchp = np.full(Lp * 9, self.C, dtype=np.int32)
        fchp[:L * 9] = fch
        fordp = np.zeros(Lp * 9, dtype=np.int32)
        fordp[:L * 9] = forder
        if not hasattr(self, "_frame_offs"):
            defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
            strip = _status_strip_map(len(defs[0].pattern),
                                      32 + LDU_DATA_DIBITS)
            self._frame_offs = jnp.asarray(np.stack(
                [strip[32 + o:32 + o + 72] for o in LDU_IMBE_OFFSETS]
            ).astype(np.int32))
        # prediction state stays device-resident between blocks (fetching
        # it would cost two more exchanges per block); the first
        # block uploads the host state once
        st = getattr(self, "_dev_pred_state", None)
        if st is None:
            st = (jnp.asarray(self.imbe_dec.prev_logm.astype(np.float32)),
                  jnp.asarray(self.imbe_dec.prev_L.astype(np.int32)))
        # synthesis carry (fundamental phase + last ω0/amps per
        # channel): a talker spanning block boundaries synthesizes
        # without a phase seam; device-resident like the pred state
        sy = getattr(self, "_dev_synth_state", None)
        if sy is None:
            from dsdneo_tpu.vocoder.synth import MAX_L as _ML
            sy = (jnp.zeros(self.C, jnp.float32),
                  jnp.zeros(self.C, jnp.float32),
                  jnp.zeros((self.C, _ML), jnp.float32))
        # frame-repeat carry: corrupt frames re-use the last good
        # parameters (≤3) before muting, across block boundaries too
        rp = getattr(self, "_dev_rep_state", None)
        pcm, f_logm, f_L, synth_out, rep_out = voice_decode_gather(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp),
            self._frame_offs, jnp.asarray(fchp), jnp.asarray(fordp),
            st[0], st[1], self.C, Tp, pcm_fmt=self.pcm_fmt,
            prev_synth=sy, rep_state=rp)
        self._dev_pred_state = (f_logm, f_L)
        self._dev_synth_state = synth_out
        self._dev_rep_state = rep_out
        return pcm

    def fetch_pcm(self, handle) -> np.ndarray:
        """Pull a decode_block_async result to host float32 PCM."""
        if handle is None or getattr(handle, "size", 1) == 0:
            return np.zeros((self.C, 0), dtype=np.float32)
        from dsdneo_tpu.ops.audio_wire import wire_expand
        return wire_expand(np.asarray(handle), self.pcm_fmt, self.C)

    def reset_voice_state(self, channels=None) -> None:
        """Clear the device-resident prediction/synthesis/repeat carry —
        every row when ``channels`` is None, else just the given rows.
        A trunked row retargeted by a grant must not phase-continue or
        frame-repeat the previous call (reference: controller thread
        re-inits per-slot mbe state on retune)."""
        attrs = ("_dev_pred_state", "_dev_synth_state", "_dev_rep_state")
        if channels is None:
            for a in attrs:
                if hasattr(self, a):
                    delattr(self, a)
            return
        from dsdneo_tpu.vocoder.device import voice_state_reset
        for a in attrs:
            st = getattr(self, a, None)
            if st is not None:
                setattr(self, a, voice_state_reset(st, channels))

    def decode_block_host(self, iq) -> np.ndarray:
        """Host-dequant variant of decode_block (reference numerics for
        the device path's parity test; same chain, numpy two-pass
        dequantization + separate synth dispatch)."""
        dibits, best_def, best_score, nid_msg = self.frontend_sync(iq)
        frames144, fch, forder = self.find_voice_frames_best(
            dibits, best_def, best_score, dibits.shape[1], nid_msg)
        if frames144.shape[0] == 0:
            return np.zeros((self.C, 0), dtype=np.float32)
        bits88, _errs = fdev.imbe_ecc_batch(frames144)
        bits88 = np.asarray(bits88)
        errs = np.asarray(_errs)
        # fleet-path mute mask (mirrors vocoder.device.imbe_frame_good):
        # non-voice codes and over-threshold frames deactivate
        from dsdneo_tpu.vocoder.imbe import B0_HI_POS, B0_LO_POS
        b0 = np.zeros(bits88.shape[0], dtype=np.int64)
        for i, p in enumerate(B0_HI_POS):
            b0 |= bits88[:, p].astype(np.int64) << (7 - i)
        b0 |= (bits88[:, B0_LO_POS[0]].astype(np.int64) << 1) \
            | bits88[:, B0_LO_POS[1]].astype(np.int64)
        good = (errs <= 5) & (b0 <= 207)

        # two-pass dequantize: the heavy per-(L,K) transforms run over
        # ALL frames at once; only the cheap inter-frame prediction
        # recurrence walks time steps
        from dsdneo_tpu.vocoder.batch import decode_transforms, run_prediction
        T_all, w0_all, L_all, K_all = decode_transforms(bits88)
        n_steps = int(forder.max()) + 1
        w0s = np.zeros((self.C, n_steps), dtype=np.float32)
        amps = np.zeros((self.C, n_steps, MAX_L), dtype=np.float32)
        voiced = np.zeros((self.C, n_steps, MAX_L), dtype=np.float32)
        # tone fields + presence for the repeat/tone contract below
        # (host mirror of vocoder.device imbe_tone_params/repeat_gate)
        w7 = 2 ** np.arange(6, -1, -1)
        id1 = bits88[:, 12:19] @ w7
        id2 = bits88[:, 19:26] @ w7
        ad = bits88[:, 26:33] @ w7
        is_tone = (b0 >= 208) & (b0 <= 219) & (id1 == id2) & (errs <= 5)
        tw0_all = (2 * np.pi * 31.25 / 8000.0) * id1.astype(np.float32)
        tamp_all = ad.astype(np.float32) * (75.0 / 8000.0)
        pres = np.zeros((self.C, n_steps), dtype=bool)
        goodm = np.zeros((self.C, n_steps), dtype=bool)
        tone_on = np.zeros((self.C, n_steps), dtype=bool)
        tone_w0 = np.zeros((self.C, n_steps), dtype=np.float32)
        tone_amp = np.zeros((self.C, n_steps), dtype=np.float32)
        for t in range(n_steps):
            sel = forder == t
            ch = fch[sel]
            T = np.zeros((self.C, MAX_L))
            w0c = np.zeros(self.C)
            Lc = np.ones(self.C, dtype=np.int64)
            Kc = np.ones(self.C, dtype=np.int64) * 3
            S = np.zeros((self.C, 88), dtype=np.uint8)
            act = np.zeros(self.C, dtype=bool)
            T[ch] = T_all[sel]
            w0c[ch] = w0_all[sel]
            Lc[ch] = L_all[sel]
            Kc[ch] = K_all[sel]
            S[ch] = bits88[sel]
            act[ch] = good[sel]
            w0_t, L_t, v_t, a_t = run_prediction(self.imbe_dec, T, w0c, Lc,
                                                 Kc, S, act)
            w0s[:, t] = w0_t
            voiced[:, t] = v_t
            amps[:, t] = a_t
            pres[ch, t] = True
            goodm[ch, t] = good[sel]
            tone_on[ch, t] = is_tone[sel]
            tone_w0[ch, t] = tw0_all[sel]
            tone_amp[ch, t] = tamp_all[sel]

        # clean tone codes synthesize single-harmonic tones; corrupt
        # frames repeat the last good parameters (≤3) before muting —
        # sequential host mirror of the device repeat gate
        w0s = np.where(tone_on, tone_w0, w0s)
        for c, t in zip(*np.nonzero(tone_on)):
            voiced[c, t] = 0.0
            voiced[c, t, 0] = 1.0
            amps[c, t] = 0.0
            amps[c, t, 0] = tone_amp[c, t] * 0.5
        goodm |= tone_on
        for c in range(self.C):
            last, reps = -1, 0
            for t in range(n_steps):
                if goodm[c, t]:
                    last, reps = t, 0
                elif pres[c, t]:
                    reps += 1
                    if last >= 0 and reps <= 3:
                        w0s[c, t] = w0s[c, last]
                        voiced[c, t] = voiced[c, last]
                        amps[c, t] = amps[c, last]
                    else:
                        w0s[c, t] = 0.0
                        voiced[c, t] = 0.0
                        amps[c, t] = 0.0

        pcm = _synth_multichannel(jnp.asarray(w0s),
                                  jnp.asarray(amps.astype(np.float16)),
                                  jnp.asarray(voiced.astype(np.float16)))
        return np.asarray(pcm).astype(np.float32).reshape(self.C, -1)


@jax.jit
def _synth_multichannel(w0: jax.Array, amps: jax.Array, voiced: jax.Array
                        ) -> jax.Array:
    """[C, F] / [C, F, L] → [C, F, 160] float16: per-channel
    phase-continuous harmonic synthesis (vmap of the single-channel
    kernel; f16 output halves the fetch, far above audio noise
    floor)."""
    from dsdneo_tpu.vocoder.synth import synthesize
    C, F, L = amps.shape
    noise = (jnp.mod(jnp.arange(C * F * L, dtype=jnp.float32) * 2.399963,
                     2 * jnp.pi)).reshape(C, F, L)
    out = jax.vmap(synthesize)(w0.astype(jnp.float32),
                               amps.astype(jnp.float32),
                               voiced.astype(jnp.float32), noise)
    return out.astype(jnp.float16)
