"""Batched many-channel CONTROL-CHANNEL decode: I/Q → trunking events.

The trunked-monitoring counterpart of engine.voicebatch/dmrbatch: at
fleet scale (256+ monitored control channels) the per-channel host
event decoder dominates, so everything through the CRC screen runs on
device and the host parses only CRC-valid payload blocks through the
existing protocol catalogs:

P25p1 TSDU (reference src/protocol/p25/phase1/p25p1_tsbk.c:1054):
  fused front end + sync + batched BCH NID (engine.voicebatch) →
  host picks DUID-7 hits from the candidate blob → device gather of
  the 3×98-dibit TSBK blocks (status-strip index maps) →
  fec.device.p25_12_decode_batch (lax.scan Viterbi over the whole
  fleet's blocks) → CRC16 screen as a GF(2) parity matmul → the host
  parses only the passing 12-byte payloads via phase1._tsbk.  Blocks
  that fail the single-best screen fall back to the host soft-LLR list
  decoder (fec.trellis.p25_12_decode_list) from the raw dibits carried
  in the same blob — the reference's tsbk_select_crc_candidate
  behavior at fleet scale.

DMR Tier III CSBK (reference src/protocol/dmr/dmr_csbk.c:2793):
  front end + data-sync correlation + batched Golay(20,8) slot-type
  decode in one dispatch → host accepts dtype-3 (CSBK) hits → device
  BPTC(196,96) decode (row Hamming(15,11) + column Hamming(13,9) as
  codebook-ML matmuls over the deinterleave gather) + CRC16(0xA5A5)
  screen → host parses passing payloads via dmr.csbk.decode_csbk.

Both pipelines keep per-channel DecoderContexts so grants feed
engine.trunk.TrunkFollower, and offer a payload-keyed parse cache:
control channels repeat identical TSBK/CSBK payloads many times per
second (ALOHA/iden/status spam), so repeats re-emit the first parse's
events without re-walking the catalog (state side effects of repeated
identical control blocks are idempotent).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.engine.p2batch import BatchedP2VoicePipeline
from dsdneo_tpu.engine.voicebatch import (BatchedP25VoicePipeline,
                                          _status_strip_map, _sync_kernel,
                                          correlate_syncs_device)
from dsdneo_tpu.fec import blockcodes, crc as crcmod
from dsdneo_tpu.fec.device import p25_12_decode_batch
from dsdneo_tpu.protocol.base import DecoderContext
from dsdneo_tpu.symbols import framesync


# -- CRC16 as GF(2) parity matmul ------------------------------------------
@lru_cache(maxsize=None)
def _crc16_contrib(nbits: int, poly: int = 0x1021) -> np.ndarray:
    """[nbits, 16] contribution table: crc16(bits, init=0, xorout=0) =
    XOR of rows at set bit positions (CRC is linear over GF(2))."""
    tab = np.zeros((nbits, 16), dtype=np.int32)
    e = np.zeros(nbits, dtype=np.uint8)
    for i in range(nbits):
        e[:] = 0
        e[i] = 1
        v = crcmod.crc16_bits(e, poly=poly, init=0, xorout=0)
        tab[i] = [(v >> (15 - j)) & 1 for j in range(16)]
    return tab


def _crc16_screen(data96: jax.Array, xor_mask: int) -> jax.Array:
    """[N, 96] payload bits → [N] bool: crc16(bits[:80], init=0) ^
    xor_mask == bits[80:96] (one [N,80]×[80,16] matmul mod 2)."""
    tab = jnp.asarray(_crc16_contrib(80))
    par = (data96[:, :80].astype(jnp.int32) @ tab) % 2        # [N, 16]
    mask = jnp.asarray([(xor_mask >> (15 - j)) & 1 for j in range(16)],
                       dtype=jnp.int32)
    return jnp.all((par ^ mask).astype(jnp.uint8)
                   == data96[:, 80:96], axis=-1)


def _pack_bits(bits: jax.Array) -> jax.Array:
    """[N, 8k] 0/1 → [N, k] bytes (msb-first)."""
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.int32)
    N = bits.shape[0]
    return (bits.reshape(N, -1, 8).astype(jnp.int32) @ w).astype(jnp.uint8)


# -- P25p1 TSDU -------------------------------------------------------------
TSDU_BLOCKS = 3          # TSBKs per TSDU (reference p25p1_tsbk.c loop)
TSDU_DATA_DIBITS = 32 + 3 * 98


@lru_cache(maxsize=1)
def _tsdu_offsets() -> np.ndarray:
    """[3, 98] stream dibit offsets (relative to sync start) of the
    three TSBK trellis blocks, status dibits stripped."""
    defs, _, _, _ = _sync_kernel(("+P25p1", "-P25p1"))
    n_pat = len(defs[0].pattern)
    strip = _status_strip_map(n_pat, TSDU_DATA_DIBITS)
    return strip[32:].reshape(3, 98).astype(np.int32)


@jax.jit
def p25_tsdu_decode_device(dibits: jax.Array, ch: jax.Array,
                           pos: jax.Array) -> jax.Array:
    """Device TSDU program: gather the 3 TSBK blocks of every accepted
    hit, batch trellis-decode, CRC16-screen; returns one compact blob
    [H, 3*(12+1+25)] = per block 12 payload bytes + ok flag + 25 bytes
    of raw packed dibits (for the host list-decode fallback on the few
    CRC-failed blocks)."""
    offs = jnp.asarray(_tsdu_offsets())
    Tn = dibits.shape[1]
    H = ch.shape[0]
    gp = jnp.clip(pos[:, None, None] + offs[None], 0, Tn - 1)  # [H, 3, 98]
    chc = jnp.minimum(ch, dibits.shape[0] - 1)
    dd = dibits[chc[:, None, None], gp].reshape(-1, 98)        # [H*3, 98]
    bits196 = jnp.zeros((dd.shape[0], 196), dtype=jnp.uint8)
    bits196 = bits196.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits196 = bits196.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    data96, _cost = p25_12_decode_batch(bits196)               # [H*3, 96]
    ok = _crc16_screen(data96, 0xFFFF)                         # [H*3]
    payload = _pack_bits(data96)                               # [H*3, 12]
    # raw dibits packed 4/byte for the host fallback path
    ddp = jnp.pad(dd, ((0, 0), (0, 2)))                        # 98 → 100
    raw = ((ddp[:, 0::4] << 6) | (ddp[:, 1::4] << 4)
           | (ddp[:, 2::4] << 2) | ddp[:, 3::4]).astype(jnp.uint8)
    blk = jnp.concatenate([payload, ok[:, None].astype(jnp.uint8), raw],
                          axis=1)                              # [H*3, 38]
    return blk.reshape(H, -1)


class BatchedP25ControlPipeline(BatchedP25VoicePipeline):
    """Batched P25p1 trunking control monitor over [C, B] blocks.

    Inherits the fused front-end + sync + NID dispatch from the voice
    pipeline (the chain is identical through the NID); picks TSDU
    (DUID 7) hits instead of LDUs and runs the TSBK path on device.
    """

    NID_TOPK = 128      # CCs carry ~13 TSDU/s plus peak shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, parse_cache: bool = True,
                 cqpsk: bool = False):
        super().__init__(C, fs=fs, sync_threshold=sync_threshold,
                         cqpsk=cqpsk)
        from dsdneo_tpu.protocol.p25.phase1 import P25P1Decoder
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.decs = [P25P1Decoder() for _ in range(C)]
        self.parse_cache = parse_cache
        self._pcache: list[dict] = [dict() for _ in range(C)]
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        self._hit_def = defs[0]
        self.crc_fallbacks = 0
        self.crc_errors = 0

    def pick_tsdus(self, idx, vq, dq, msg, T: int, dibits_dev=None):
        # acceptance extent is the MINIMUM TSDU (one trellis block):
        # a Last-Block-flagged single-TSBK TSDU is only ~106 dibits, so
        # LSM control channels run TSDUs at a 180-dibit stride — the
        # full 3-block extent would suppress every other one.  False
        # syncs inside a longer TSDU are already rejected by the
        # BCH-validated DUID gate.
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        n_pat = len(defs[0].pattern)
        strip = _status_strip_map(n_pat, 32 + 98)
        need = int(strip[-1]) + 1
        ac, at, am, _fch, _ford = self.pick_frames_by_duid(
            idx, vq, dq, msg, T, (7,), need, 1, dibits_dev)
        return ac, at, am

    def _parse_tsbk(self, c: int, pos: int, payload12: np.ndarray) -> bool:
        """Host catalog parse of one CRC-valid TSBK payload; returns the
        Last Block flag.  With parse_cache, repeats of an identical
        payload re-emit the first parse's events."""
        ctx = self.ctxs[c]
        # the iden-table version joins the key: freq-note lines change
        # once iden_up populates the channel→frequency math
        iden_v = getattr(getattr(ctx.state, "iden_table", None),
                         "version", 0)
        key = (payload12.tobytes(), iden_v)
        if self.parse_cache:
            hitv = self._pcache[c].get(key)
            if hitv is not None:
                lb, events = hitv
                for line, fields in events:
                    ctx.emit(line, "p25p1", pos, **fields)
                return lb
        bits96 = np.unpackbits(payload12)
        hit = framesync.SyncHit(pos=pos, score=1.0, sync=self._hit_def)
        n0 = len(ctx.events)
        lb = self.decs[c]._tsbk(bits96, hit, ctx)
        if self.parse_cache:
            pc = self._pcache[c]
            if len(pc) >= 4096:
                # bound long-running monitors: varying payloads (time
                # broadcasts, grants) and iden-version bumps would
                # otherwise accrete dead entries forever; a clear
                # rebuilds from live traffic in a few blocks
                pc.clear()
            pc[key] = (
                lb, [(e.line, dict(e.fields)) for e in ctx.events[n0:]])
        return lb

    def decode_block_events(self, iq) -> int:
        """Run one [C, B] block end to end; events land in
        ``self.ctxs[c].events``.  Returns the number of CRC-valid TSBKs
        parsed."""
        return self.events_from_frontend(
            self.frontend_finish(self.frontend_dispatch(iq)))

    def events_from_frontend(self, fe6, cofetch=None):
        """Second fleet-pipeline stage: pick + device TSBK decode +
        host catalog parse from a finished frontend exchange (see
        FleetMonitor.decode_block phase ordering).

        ``cofetch``: optional device array (e.g. the voice pipeline's
        PCM wire) fetched in the SAME device-to-host exchange as the
        TSDU blob, so the closed trunking loop makes one exchange per
        block (returns ``(n_parsed, cofetch_np)`` instead of
        ``n_parsed``)."""
        import jax
        dibits_dev, idx, vq, dq, msg, n_sym = fe6
        ac, at, am = self.pick_tsdus(idx, vq, dq, msg, n_sym,
                                     dibits_dev=dibits_dev)
        H = ac.shape[0]
        if H == 0:
            if cofetch is not None:
                return 0, jax.device_get(cofetch)
            return 0
        Hp = -(-H // 64) * 64
        acp = np.full(Hp, self.C, dtype=np.int32)
        acp[:H] = ac
        atp = np.zeros(Hp, dtype=np.int32)
        atp[:H] = at
        blob_dev = p25_tsdu_decode_device(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp))
        if cofetch is not None:
            blob, co_np = jax.device_get((blob_dev, cofetch))
        else:
            blob, co_np = np.asarray(blob_dev), None
        blk = blob[:H].reshape(H, 3, 38)
        payloads = blk[:, :, :12]
        oks = blk[:, :, 12] != 0
        raws = blk[:, :, 13:38]
        n_parsed = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            ctx = self.ctxs[c]
            nac = (int(am[h]) >> 4) & 0xFFF
            if nac not in (0, 0xFFF):
                ctx.state.nac = nac
                ctx.state.p2_cc = nac
            ctx.emit(f"Sync: +P25p1 | {ctx.frame_info()}TSDU",
                     "p25p1", t, nac=nac, duid=7)
            for b in range(TSDU_BLOCKS):
                if oks[h, b]:
                    data = payloads[h, b]
                else:
                    data = self._crc_fallback(raws[h, b])
                    if data is None:
                        self.crc_errors += 1
                        self.ctxs[c].emit(" TSBK CRC ERR", "p25p1", t)
                        break
                    self.crc_fallbacks += 1
                n_parsed += 1
                if self._parse_tsbk(c, t, data):
                    break
        if cofetch is not None:
            return n_parsed, co_np
        return n_parsed

    @staticmethod
    def _crc_fallback(raw25: np.ndarray) -> np.ndarray | None:
        """Host ranked-list trellis decode of one CRC-failed block from
        its packed raw dibits (reference tsbk_select_crc_candidate)."""
        from dsdneo_tpu.fec import trellis
        dd = np.zeros(100, dtype=np.uint8)
        dd[0::4] = (raw25 >> 6) & 3
        dd[1::4] = (raw25 >> 4) & 3
        dd[2::4] = (raw25 >> 2) & 3
        dd[3::4] = raw25 & 3
        bits = np.zeros(196, dtype=np.uint8)
        bits[0::2] = (dd[:98] >> 1) & 1
        bits[1::2] = dd[:98] & 1
        for data96, _m in trellis.p25_12_decode_list(bits):
            got = crcmod.crc16_bits(data96[:80], init=0, xorout=0xFFFF)
            want = 0
            for v in data96[80:96]:
                want = (want << 1) | int(v)
            if got == want:
                return np.packbits(data96)
        return None

    def events(self, c: int):
        return self.ctxs[c].events


# -- DMR Tier III CSBK ------------------------------------------------------
@lru_cache(maxsize=1)
def _bptc_consts():
    """Deinterleave gather [13, 15] into the 196 on-air bits, plus the
    row/column codebooks (fec.bptc host tables)."""
    # deinterleaved d[(i*13) % 196] = bits[i]  ⇒  d[j] = bits[(j*181) % 196]
    inv = (np.arange(196) * 181) % 196
    mat_idx = inv[1:].reshape(13, 15).astype(np.int32)
    h15 = blockcodes.hamming_15_11()
    h13 = blockcodes.hamming_13_9()
    return mat_idx, h15, h13


@jax.jit
def bptc_196_96_decode_batch(bits196: jax.Array
                             ) -> tuple[jax.Array, jax.Array]:
    """Batched BPTC(196,96): [N, 196] on-air bits → ([N, 96] payload,
    [N] error count).  Bit-identical to fec.bptc.bptc_196_96_decode:
    row Hamming(15,11) ML decode corrects data columns of rows 0-8,
    then column Hamming(13,9) ML over the partially corrected matrix
    corrects rows 0-8 of every column; errors counts codewords needing
    >1-bit correction."""
    mat_idx, h15, h13 = _bptc_consts()
    N = bits196.shape[0]
    mat = bits196[:, jnp.asarray(mat_idx.reshape(-1))].reshape(N, 13, 15)

    pm15 = jnp.asarray((1.0 - 2.0 * h15.codebook).astype(np.float32))
    cb15 = jnp.asarray(h15.codebook)
    rows = mat[:, :9].reshape(N * 9, 15)
    s = 1.0 - 2.0 * rows.astype(jnp.float32)
    m = jnp.argmax(jnp.matmul(s, pm15.T, precision=jax.lax.Precision.HIGHEST),
                   axis=-1)
    rerr = jnp.sum(cb15[m] != rows, axis=-1).reshape(N, 9)
    mat = mat.at[:, :9, :11].set(cb15[m][:, :11].reshape(N, 9, 11))

    pm13 = jnp.asarray((1.0 - 2.0 * h13.codebook).astype(np.float32))
    cb13 = jnp.asarray(h13.codebook)
    cols = jnp.swapaxes(mat, 1, 2).reshape(N * 15, 13)
    s = 1.0 - 2.0 * cols.astype(jnp.float32)
    m = jnp.argmax(jnp.matmul(s, pm13.T, precision=jax.lax.Precision.HIGHEST),
                   axis=-1)
    cerr = jnp.sum(cb13[m] != cols, axis=-1).reshape(N, 15)
    fixed = jnp.swapaxes(cb13[m][:, :9].reshape(N, 15, 9), 1, 2)
    mat = mat.at[:, :9, :].set(fixed)

    payload = jnp.concatenate(
        [mat[:, 0, 3:11], mat[:, 1:9, :11].reshape(N, 88)], axis=1)
    errors = (jnp.sum(rerr > 1, axis=-1) + jnp.sum(cerr > 1, axis=-1)
              ).astype(jnp.int32)
    return payload.astype(jnp.uint8), errors


# slot-type field: 5 dibits before the 24-dibit sync + 5 after
_ST_OFFS = np.array([-5, -4, -3, -2, -1, 24, 25, 26, 27, 28],
                    dtype=np.int32)
# CSBK payload: 49 dibits ending 5 dibits before sync + 49 starting
# 5 dibits after it (protocol/dmr/bs.py _data_burst geometry)
_PAYLOAD_OFFS = np.concatenate([np.arange(-54, -5), np.arange(29, 78)]
                               ).astype(np.int32)
DMR_BURST_EXTENT = 78


@jax.jit
def dmr_csbk_decode_device(dibits: jax.Array, ch: jax.Array,
                           pos: jax.Array, inv: jax.Array
                           ) -> jax.Array:
    """Device CSBK program: gather each accepted data burst's 196
    payload bits, batched BPTC decode, CRC16(0xA5A5) screen; blob
    [H, 14] = 12 payload bytes + ok flag + BPTC error count."""
    Tn = dibits.shape[1]
    gp = jnp.clip(pos[:, None] + jnp.asarray(_PAYLOAD_OFFS), 0, Tn - 1)
    chc = jnp.minimum(ch, dibits.shape[0] - 1)
    dd = dibits[chc[:, None], gp]                              # [H, 98]
    dd = dd ^ (inv[:, None] * 2).astype(dd.dtype)
    bits196 = jnp.zeros((dd.shape[0], 196), dtype=jnp.uint8)
    bits196 = bits196.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits196 = bits196.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    payload, errors = bptc_196_96_decode_batch(bits196)
    ok = _crc16_screen(payload, 0xFFFF ^ 0xA5A5)
    pb = _pack_bits(payload)                                   # [H, 12]
    return jnp.concatenate(
        [pb, ok[:, None].astype(jnp.uint8),
         jnp.clip(errors, 0, 255)[:, None].astype(jnp.uint8)], axis=1)


# -- EDACS control channel --------------------------------------------------
@lru_cache(maxsize=1)
def _edacs_consts():
    from dsdneo_tpu.protocol.edacs.decoder import _bch_basis
    return _bch_basis().astype(np.int32)        # [28, 12] parity rows


@jax.jit
def edacs_cc_decode_device(dibits: jax.Array, ch: jax.Array,
                           pos: jax.Array) -> jax.Array:
    """Device EDACS program: gather each frame's 240 message dibits
    (2-level: the sign bit is the data bit), bitwise 2-of-3 majority
    vote over the three copies of each 40-bit word, BCH(40,28) parity
    screen for BOTH polarities (an inverted channel complements every
    word — protocol/edacs/decoder.py handle); blob [H, 12] = msg1 4B +
    msg2 4B (28-bit, post-polarity) + ok + inv + 2 pad."""
    basis = jnp.asarray(_edacs_consts())
    Tn = dibits.shape[1]
    gp = jnp.clip(pos[:, None] + jnp.arange(240), 0, Tn - 1)
    chc = jnp.minimum(ch, dibits.shape[0] - 1)
    bits = ((dibits[chc[:, None], gp] >> 1) & 1).astype(jnp.int32)
    fr = bits.reshape(-1, 6, 40)
    m1 = (fr[:, 0] + fr[:, 1] + fr[:, 2] >= 2).astype(jnp.int32)  # [H, 40]
    m2 = (fr[:, 3] + fr[:, 4] + fr[:, 5] >= 2).astype(jnp.int32)

    def bch_ok(w):                               # [H, 40] → [H] bool
        par = (w[:, :28] @ basis) % 2
        return jnp.all(par == w[:, 28:40], axis=-1)

    ok_n = bch_ok(m1) & bch_ok(m2)
    ok_c = bch_ok(1 - m1) & bch_ok(1 - m2)
    inv = (~ok_n) & ok_c
    ok = ok_n | ok_c
    m1f = jnp.where(inv[:, None], 1 - m1, m1)
    m2f = jnp.where(inv[:, None], 1 - m2, m2)
    w28 = jnp.asarray([1 << (27 - i) for i in range(28)], jnp.int32)
    v1 = (m1f[:, :28] * w28).sum(axis=1)
    v2 = (m2f[:, :28] * w28).sum(axis=1)
    u8 = lambda a: jax.lax.bitcast_convert_type(
        a.astype(jnp.uint32), jnp.uint8).reshape(a.shape[0], -1)
    return jnp.concatenate(
        [u8(v1), u8(v2), ok[:, None].astype(jnp.uint8),
         inv[:, None].astype(jnp.uint8),
         jnp.zeros((v1.shape[0], 2), jnp.uint8)], axis=1)


class BatchedEdacsControlPipeline:
    """Batched EDACS trunking control monitor (reference
    edacs_process_valid_frame at fleet scale): front end + sync
    correlation on device, 2-of-3 vote + dual-polarity BCH(40,28)
    screen on device, host parses only valid message pairs through the
    standard/EA catalogs."""

    SYNC_NAMES = ("+EDACS", "-EDACS")
    SYNC_TOPK = 96              # ~33 frames/s + shoulders
    FRAME_EXTENT = 48 + 240

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, ea_mode: bool = False,
                 esk_mask: int = 0):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        from dsdneo_tpu.protocol.edacs.decoder import EdacsDecoder
        self.C = C
        self.fs = fs
        self.mode = MODES["edacs"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        for ctx in self.ctxs:
            ctx.state.edacs_ea = ea_mode
            ctx.state.edacs_esk = esk_mask
        self.decs = [EdacsDecoder() for _ in range(C)]
        self.bch_errors = 0
        self._jits = {}

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def frontend_dispatch(self, iq):
        """Power-gated front end (the windowed-robust slicing the
        serial demod path uses — see engine.demod.gated_frontend_step;
        EDACS 2-level GFSK needs the same level discipline as the
        bursty protocols).  Enqueues the device program WITHOUT
        fetching the candidate blob (fleet pipelining)."""
        from dsdneo_tpu.engine.demod import gated_frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("edacs", B, n_sym)
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
        n_pat = len(_sync_kernel(self.SYNC_NAMES)[0][0].pattern)
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
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                j = k
                if t - last < self.FRAME_EXTENT - 8 \
                        or t + n_pat + 240 >= n_sym:
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t + n_pat)          # message start
        return np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32)

    def decode_block_events(self, iq) -> int:
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe4) -> int:
        dibits_dev, idx, vq, n_sym = fe4
        ac, at = self.pick_frames(idx, vq, n_sym)
        H = ac.shape[0]
        if H == 0:
            return 0
        Hp = -(-H // 32) * 32
        acp = np.full(Hp, self.C, dtype=np.int32)
        acp[:H] = ac
        atp = np.zeros(Hp, dtype=np.int32)
        atp[:H] = at
        blob = np.asarray(edacs_cc_decode_device(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp)))[:H]
        n = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            ctx = self.ctxs[c]
            if not blob[h, 8]:
                self.bch_errors += 1
                ctx.emit("Sync: +EDACS  BCH FAIL", "edacs", t)
                continue
            v1 = int(blob[h, 0:4].copy().view(np.uint32)[0])
            v2 = int(blob[h, 4:8].copy().view(np.uint32)[0])
            esk = int(getattr(ctx.state, "edacs_esk", 0) or 0)
            if esk:
                v1 ^= (esk & 0xFF) << 20
                v2 ^= (esk & 0xFF) << 20
            dec = self.decs[c]
            hit = framesync.SyncHit(
                pos=t, score=1.0,
                sync=_sync_kernel(self.SYNC_NAMES)[0][0])
            if getattr(ctx.state, "edacs_ea", False):
                line = dec._extended(v1, v2, ctx, hit)
            else:
                line = dec._standard(v1, v2, ctx, hit)
            pol = "-" if blob[h, 9] else "+"
            ctx.emit(f"Sync: {pol}EDACS {line}", "edacs", t,
                     mt=v1 >> 23, word=v1)
            n += 1
        return n

    def events(self, c: int):
        return self.ctxs[c].events


# -- NXDN RCCH CAC ----------------------------------------------------------
@lru_cache(maxsize=1)
def _cac_consts():
    """Static CAC decode tables: payload gather offsets (descramble
    flips included), the PERM_12_25 depermute → 12:14 depuncture index
    map into the 350-symbol Viterbi input, and the affine CRC16-CAC
    screen tables (protocol/nxdn/decoder.py _cac / crc16_cac)."""
    from dsdneo_tpu.protocol.nxdn.decoder import (_PERM_12_25, crc16_cac,
                                                  _pn9_scramble_positions)
    # CAC field = descrambled frame dibits 8..158 (bits[16:316]);
    # stream offset = FSW start + 10 (sync) + payload dibit index
    scram = np.zeros(182, dtype=np.uint8)
    scram[_pn9_scramble_positions()] = 1
    p = np.arange(8, 158)
    offs = (10 + p).astype(np.int32)             # [150] dibit offsets
    flips = scram[p].astype(np.uint8)            # [150]
    # deperm[_PERM_12_25] = bits300  ⇒  deperm[j] = bits300[inv[j]]
    inv = np.argsort(_PERM_12_25).astype(np.int32)
    # 12:14 depuncture: group g symbol i ← deperm[g*12 + m]
    mapping = [0, 1, 2, None, 3, 4, 5, 6, 7, 8, 9, None, 10, 11]
    src_idx = np.zeros(350, dtype=np.int32)
    wt = np.zeros(350, dtype=np.float32)
    for g in range(25):
        for i, m in enumerate(mapping):
            if m is not None:
                src_idx[g * 14 + i] = inv[g * 12 + m]
                wt[g * 14 + i] = 1.0
    # affine CRC16-CAC screen: crc(bits) = A ^ XOR(C_i over set bits)
    zero = np.zeros(171, dtype=np.uint8)
    A = crc16_cac(zero)
    tab = np.zeros((171, 16), dtype=np.int32)
    e = zero.copy()
    for i in range(171):
        e[:] = 0
        e[i] = 1
        v = crc16_cac(e) ^ A
        tab[i] = [(v >> (15 - j)) & 1 for j in range(16)]
    a_bits = np.asarray([(A >> (15 - j)) & 1 for j in range(16)],
                        dtype=np.int32)
    return offs, flips, src_idx, wt, a_bits, tab


@jax.jit
def nxdn_cac_decode_device(dibits: jax.Array, ch: jax.Array,
                           pos: jax.Array) -> jax.Array:
    """Device CAC program: gather + descramble the 150 CAC dibits of
    every accepted RCCH frame, depermute/depuncture, batched K=5
    Viterbi (fec.device.conv_k5_decode_batch), CRC16-CAC screen; blob
    [H, 23] = 22 packed payload bytes (171 bits + pad) + ok flag."""
    from dsdneo_tpu.fec.device import conv_k5_decode_batch
    offs, flips, src_idx, wt, a_bits, tab = _cac_consts()
    Tn = dibits.shape[1]
    gp = jnp.clip(pos[:, None] + jnp.asarray(offs), 0, Tn - 1)
    chc = jnp.minimum(ch, dibits.shape[0] - 1)
    dd = dibits[chc[:, None], gp] ^ (jnp.asarray(flips) * 2)  # [H, 150]
    bits300 = jnp.zeros((dd.shape[0], 300), dtype=jnp.uint8)
    bits300 = bits300.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits300 = bits300.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    sym = bits300[:, jnp.asarray(src_idx)].astype(jnp.float32)
    wts = jnp.broadcast_to(jnp.asarray(wt), sym.shape)
    dec = conv_k5_decode_batch(sym, wts)[:, :171]            # [H, 171]
    par = (dec.astype(jnp.int32) @ jnp.asarray(tab)) % 2
    ok = jnp.all(par == jnp.asarray(a_bits), axis=-1)
    pad = jnp.zeros((dec.shape[0], 5), dtype=jnp.uint8)
    pb = _pack_bits(jnp.concatenate([dec.astype(jnp.uint8), pad], axis=1))
    return jnp.concatenate([pb, ok[:, None].astype(jnp.uint8)], axis=1)


class BatchedNxdnControlPipeline:
    """Batched NXDN RCCH monitor (reference nxdn CAC path at fleet
    scale): the nxdnbatch fused front end supplies the per-candidate
    LICH bytes; CAC frames (LICH profile flag) decode on device through
    the batched K=5 Viterbi + CRC16-CAC screen; the host parses only
    valid payloads through the NXDN message catalog."""

    # CAC-bearing LICH values (protocol/nxdn/decoder _LICH_PROFILES)
    _CAC_LICH = {0x01, 0x05}

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.55, mode: str = "nxdn48"):
        from dsdneo_tpu.engine.nxdnbatch import BatchedNxdnVoicePipeline
        from dsdneo_tpu.protocol.nxdn.decoder import NxdnDecoder
        self._fe = BatchedNxdnVoicePipeline(C, fs=fs,
                                            sync_threshold=sync_threshold,
                                            mode=mode)
        self.C = C
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        for ctx in self.ctxs:
            ctx.mode_name = mode
        self.decs = [NxdnDecoder() for _ in range(C)]
        self.crc_errors = 0

    def pick_cacs(self, idx, vq, dq, lich, n_sym: int):
        """Threshold + shoulder suppression + LICH parity/profile gate
        → accepted (channel, FSW position, lich) lists."""
        from dsdneo_tpu.engine.nxdnbatch import (FRAME_DIBITS,
                                                 _lich_parity_ok)
        acc_c, acc_t, acc_l = [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            lichs = lich[c][ok][order]
            last = -10 ** 9
            j = 0
            while j < len(positions):
                t = int(positions[j])
                # shoulder refinement: best score within 8 positions
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                lf = int(lichs[w])
                j = k
                # stride only from ACCEPTED frames: random candidates
                # with accidentally-valid parity must not suppress a
                # true frame behind them
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    continue
                if not _lich_parity_ok(lf):
                    continue
                if (lf >> 1) in self._CAC_LICH:
                    last = t
                    acc_c.append(c)
                    acc_t.append(t)
                    acc_l.append(lf >> 1)
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_l, np.int32))

    def frontend_dispatch(self, iq):
        return self._fe.frontend_dispatch(iq)

    def frontend_finish(self, fe):
        return self._fe.frontend_finish(fe)

    def decode_block_events(self, iq) -> int:
        """One [C, B] block → RCCH events in self.ctxs; returns the
        number of CRC-valid CACs parsed."""
        return self.events_from_frontend(
            self._fe.frontend_sync_device(iq))

    def events_from_frontend(self, fe6) -> int:
        dibits_dev, idx, vq, dq, lich, n_sym = fe6
        ac, at, al = self.pick_cacs(idx, vq, dq, lich, n_sym)
        H = ac.shape[0]
        if H == 0:
            return 0
        Hp = -(-H // 32) * 32
        acp = np.full(Hp, self.C, dtype=np.int32)
        acp[:H] = ac
        atp = np.zeros(Hp, dtype=np.int32)
        atp[:H] = at
        blob = np.asarray(nxdn_cac_decode_device(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp)))[:H]
        n = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            ctx = self.ctxs[c]
            if not blob[h, 22]:
                self.crc_errors += 1
                ctx.emit(" CAC CRC ERR", "nxdn", t)
                continue
            dec = np.unpackbits(blob[h, :22])[:171]
            ran = 0
            for b in dec[2:8]:
                ran = (ran << 1) | int(b)
            ctx.state.nxdn_ran = ran
            detail = self.decs[c]._message(dec[8:155], ctx)
            ctx.emit(f"Sync: NXDN CC  RCCH CAC RAN {ran:02d}{detail}",
                     "nxdn", t, ran=ran)
            n += 1
        return n

    def events(self, c: int):
        return self.ctxs[c].events


class BatchedDmrControlPipeline:
    """Batched DMR Tier III CSBK monitor over [C, B] blocks (reference
    dmr_csbk.c catalog at fleet scale): data-sync correlation + batched
    Golay(20,8) slot-type decode in the front-end dispatch, device
    BPTC + CRC screen, host catalog parse of CRC-valid CSBKs."""

    # DMR data and voice syncs are exact symbol complements, so a
    # voice-pattern hit on an inverted channel is really a data burst:
    # pattern 0 = upright data, pattern 1 (the voice pattern) = the
    # inverted-data hypothesis, disambiguated by the slot-type Golay
    # confidence gate — the serial decoder's exact logic
    # (protocol/dmr/bs.py handle: data_invert = base ^ is_voice_pattern)
    SYNC_NAMES = ("+DMR BS data", "+DMR BS voice")
    SYNC_TOPK = 192          # ~16.7 data bursts/s per slot + shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, parse_cache: bool = True):
        from dsdneo_tpu.dsp import firdes
        from dsdneo_tpu.engine.modes import MODES
        self.C = C
        self.fs = fs
        self.mode = MODES["dmr"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = firdes.channel_lpf(fs, self.mode.lpf_profile)
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.parse_cache = parse_cache
        self._pcache: list[dict] = [dict() for _ in range(C)]
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        self._hit_def = defs[0]
        self.crc_errors = 0
        self._jits = {}

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def frontend_dispatch(self, iq):
        """Fused front end + data-sync correlation + slot-type Golay:
        dibits stay on device; the blob carries top-K candidate
        positions, scores, pattern ids, and slot-type (msg, errs).
        Enqueues the device program WITHOUT fetching the blob."""
        from dsdneo_tpu.engine.batched import frontend_step
        B = iq.shape[1]
        n_sym = int(B // self.sps) - 2
        key = ("dmrcc", B, n_sym)
        fn = self._jits.get(key)
        if fn is None:
            taps = self.taps
            names = self.SYNC_NAMES
            defs, _, _, n_max_pat = _sync_kernel(names)
            k_cand = min(self.SYNC_TOPK, n_sym - n_max_pat + 1)
            g20 = blockcodes.golay_20_8()
            pm20_n = (1.0 - 2.0 * g20.codebook).astype(np.float32)
            cb20_n = g20.codebook

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
                # batched slot-type decode at every candidate
                Cn = dibits.shape[0]
                Tn = dibits.shape[1]
                gp = jnp.clip(idx[:, :, None] + jnp.asarray(_ST_OFFS),
                              0, Tn - 1)
                dd = dibits[jnp.arange(Cn)[:, None, None], gp]
                # pattern 1 (voice) = inverted-data hypothesis
                invq = (dq & 1).astype(jnp.uint8)
                dd = dd ^ (invq[:, :, None] * 2)
                b20 = jnp.stack([(dd >> 1) & 1, dd & 1],
                                axis=-1).reshape(Cn, k_cand, 20)
                s = 1.0 - 2.0 * b20.astype(jnp.float32)
                scores = jnp.einsum("ckb,eb->cke", s, jnp.asarray(pm20_n),
                                    precision=jax.lax.Precision.HIGHEST)
                m = jnp.argmax(scores, axis=-1)
                errs = jnp.sum(jnp.asarray(cb20_n)[m] != b20, axis=-1)
                u8 = lambda a: jax.lax.bitcast_convert_type(
                    a, jnp.uint8).reshape(a.shape[0], -1)
                blob = jnp.concatenate(
                    [u8(idx.astype(jnp.uint16)), vq, dq,
                     m.astype(jnp.uint8),
                     jnp.clip(errs, 0, 255).astype(jnp.uint8)], axis=1)
                return dibits, blob
            self._jits[key] = fn
        dibits_dev, blob_dev = fn(
            iq if isinstance(iq, jax.Array) else jnp.asarray(iq))
        return dibits_dev, blob_dev, n_sym

    def frontend_finish(self, fe):
        dibits_dev, blob_dev, n_sym = fe
        blob = np.asarray(blob_dev)
        defs, _, _, n_max = _sync_kernel(self.SYNC_NAMES)
        k_cand = min(self.SYNC_TOPK, n_sym - n_max + 1)
        o = 0
        idx = blob[:, o:o + 2 * k_cand].copy().view(np.uint16
                                                    ).astype(np.int64)
        o += 2 * k_cand
        vq = blob[:, o:o + k_cand]; o += k_cand
        dq = blob[:, o:o + k_cand]; o += k_cand
        st = blob[:, o:o + k_cand]; o += k_cand
        se = blob[:, o:o + k_cand]
        return dibits_dev, idx, vq, dq, st, se, n_sym

    def pick_csbks(self, idx, vq, dq, st, se, n_sym: int):
        """Data-sync hits → accepted (channel, pos, inverted, cc) for
        dtype-3 CSBK bursts: correlation threshold, slot-type Golay
        confidence ≤2 bit errors (host _slot_type gate), shoulder
        suppression.  Pattern 1 hits are the inverted-data hypothesis."""
        acc_c, acc_t, acc_i, acc_cc = [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = (sc >= self.threshold) & (se[c] <= 2)
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            pdefs = dq[c][ok][order]
            types = st[c][ok][order]
            last = -10 ** 9
            for t, dfi, m in zip(positions, pdefs, types):
                t = int(t)
                if t - last < 24 or t < 54 or t + DMR_BURST_EXTENT >= n_sym:
                    continue
                last = t
                dtype = int(m) & 0xF
                if dtype != 3:          # CSBK only on the batched path
                    continue
                acc_c.append(c)
                acc_t.append(t)
                acc_i.append(int(dfi) & 1)
                acc_cc.append((int(m) >> 4) & 0xF)
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_i, np.int32), np.asarray(acc_cc, np.int32))

    def _parse_csbk(self, c: int, pos: int, cc: int,
                    payload12: np.ndarray) -> None:
        from dsdneo_tpu.protocol.dmr.csbk import decode_csbk
        ctx = self.ctxs[c]
        key = payload12.tobytes()
        if self.parse_cache:
            hitv = self._pcache[c].get(key)
            if hitv is not None:
                for line, fields in hitv:
                    ctx.emit(line, "dmr", pos, **fields)
                return
        bits96 = np.unpackbits(payload12)
        hit = framesync.SyncHit(pos=pos, score=1.0, sync=self._hit_def)
        n0 = len(ctx.events)
        detail = decode_csbk(bits96, ctx, hit=hit, slot=0)
        ctx.emit(f"Sync: +DMR CC | Color Code={cc:02d} | CSBK{detail}",
                 "dmr", pos, cc=cc)
        if self.parse_cache:
            pc = self._pcache[c]
            if len(pc) >= 4096:
                pc.clear()        # bounded (see P25 TSBK cache note)
            pc[key] = [(e.line, dict(e.fields))
                       for e in ctx.events[n0:]]

    def decode_block_events(self, iq) -> int:
        """One [C, B] block → CSBK events in self.ctxs; returns the
        number of CRC-valid CSBKs parsed."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe7) -> int:
        dibits_dev, idx, vq, dq, st, se, n_sym = fe7
        ac, at, ai, acc = self.pick_csbks(idx, vq, dq, st, se, n_sym)
        H = ac.shape[0]
        if H == 0:
            return 0
        Hp = -(-H // 64) * 64
        acp = np.full(Hp, self.C, dtype=np.int32)
        acp[:H] = ac
        atp = np.zeros(Hp, dtype=np.int32)
        atp[:H] = at
        aip = np.zeros(Hp, dtype=np.int32)
        aip[:H] = ai
        blob = np.asarray(dmr_csbk_decode_device(
            dibits_dev, jnp.asarray(acp), jnp.asarray(atp),
            jnp.asarray(aip)))[:H]
        n_parsed = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            if blob[h, 13] > 0 and not blob[h, 12]:
                # unrecovered BPTC burst: the serial path emits the
                # burst head with no detail (bs.py errors==0 gate)
                self.ctxs[c].emit(
                    f"Sync: +DMR CC | Color Code={int(acc[h]):02d}"
                    " | CSBK", "dmr", t)
            elif blob[h, 12]:
                self._parse_csbk(c, t, int(acc[h]), blob[h, :12])
                n_parsed += 1
            else:
                self.crc_errors += 1
                self.ctxs[c].emit(
                    f"Sync: +DMR CC | Color Code={int(acc[h]):02d}"
                    " | CSBK CRC ERR", "dmr", t)
        return n_parsed

    def events(self, c: int):
        return self.ctxs[c].events


# -- P25 Phase 2 TDMA control channel ----------------------------------------
@jax.jit
def p2_xcch_gather_device(dibits: jax.Array, ch: jax.Array,
                          tpos: jax.Array) -> jax.Array:
    """Gather the 180 dibits of every accepted xCCH timeslot and PACK
    to [N, 45] bytes (360 bits msb-first; reference p25p2_frame.c
    timeslot geometry; the 4th burst of a frame is only 320 bits — its
    tail gathers the next sync, which the payload/parity extraction
    never reads).  Packed on device: at fleet scale the burst blob is
    the monitor's largest d2h transfer (23k bursts/s·block = 8.3 MB
    unpacked vs 1.0 MB packed; the host unpackbits is ~3 ms)."""
    from dsdneo_tpu.engine.p2batch import TS_DIBITS
    Tn = dibits.shape[1]
    gp = jnp.clip(tpos[:, None] + jnp.arange(TS_DIBITS), 0, Tn - 1)
    chc = jnp.minimum(ch, dibits.shape[0] - 1)
    dd = dibits[chc[:, None], gp]                          # [N, 180]
    bits = jnp.zeros((dd.shape[0], 360), dtype=jnp.uint8)
    bits = bits.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    bits = bits.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    return _pack_bits(bits)


@lru_cache(maxsize=1)
def _xcch_index_arrays():
    """(payload, parity) bit-position arrays per xCCH kind (the
    vectorized form of p2_xcch.extract_sacch/extract_facch)."""
    sp = np.r_[2:74, 76:184].astype(np.int64)
    sq = np.r_[184:244, 246:318].astype(np.int64)
    fp = np.r_[2:74, 76:138, 180:202].astype(np.int64)
    fq = np.r_[202:244, 246:318].astype(np.int64)
    return {"sacch": (sp, sq), "facch": (fp, fq)}


class BatchedP2ControlPipeline(BatchedP2VoicePipeline):
    """Batched P25 Phase 2 TDMA control-channel monitor over [C, B]
    blocks (reference ``state->p25_cc_is_tdma``: a TDMA LCCH control
    channel at 6000 sym/s, src/protocol/p25/p25_trunk_sm.c:289 +
    phase2/p25p2_vpdu.c MAC_SIGNAL handling).

    Inherits the Phase 2 frontend (sync + DUID + ISCH typing) from the
    voice pipeline; instead of voice timeslots it accepts the xCCH
    bursts (SACCH/FACCH/LCCH), gathers them on device, and screens them
    with two GF(2) matmuls — the systematic RS(63,35) encode map
    (p2_xcch.xcch_encode_matrix) and the CRC12 contribution table — so
    the host only MAC-parses clean bursts; channel-errored bursts fall
    back to the serial Berlekamp–Massey erasure decode.  With
    ``wacn=sysid=nac=0`` the scramble parameters are blind-recovered
    from RS parity linearity per channel (phase2._try_recover_params),
    decoding control channels the reference needs NET_STS or -X for.
    """

    # duid → (kind, scrambled, lcch); reference p25p2_frame.c typing
    XCCH_DUIDS = {3: ("sacch", True, False), 12: ("sacch", False, False),
                  4: ("sacch", True, True), 13: ("sacch", False, True),
                  9: ("facch", True, False), 15: ("facch", False, False)}

    def __init__(self, C: int, fs: float = 48000.0, wacn: int = 0,
                 sysid: int = 0, nac: int = 0,
                 sync_threshold: float = 0.62, parse_cache: bool = True):
        super().__init__(C, fs=fs, wacn=wacn, sysid=sysid, nac=nac,
                         sync_threshold=sync_threshold)
        from dsdneo_tpu.protocol.p25.phase2 import P25P2Decoder
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.decs = [P25P2Decoder() for _ in range(C)]
        if wacn and sysid and nac:
            for ctx in self.ctxs:
                s = ctx.state
                s.p2_wacn, s.p2_sysid, s.p2_cc = wacn, sysid, nac
                s.nac = nac
        self.parse_cache = parse_cache
        self._pcache: list[dict] = [dict() for _ in range(C)]
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        self._hit_def = defs[0]
        self._scr_tables: dict = {}
        self.rs_fallbacks = 0
        self.crc_errors = 0

    # -- host walk ---------------------------------------------------------
    def pick_xcch(self, idx, vq, duid, isch, n_sym: int):
        """Accepted frames → per-timeslot xCCH job arrays
        (ch, tpos, sfpos, duid_idx, slot) — the control-channel
        counterpart of walk_frames' voice selection, sharing its
        batched ISCH superframe resolution."""
        from dsdneo_tpu.engine.p2batch import FRAME_DIBITS, TS_DIBITS
        defs, _, _, _ = _sync_kernel(self.SYNC_NAMES)
        n_pat = len(defs[0].pattern)
        duid_lut = self._duid_lut()
        oka, sf_start_all = self._resolve_isch_batch(vq, isch)
        j_ch, j_tpos, j_sf, j_duid, j_slot = ([] for _ in range(5))
        for c in range(idx.shape[0]):
            ok = oka[c]
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            duids_v = duid_lut[duid[c][ok][order]]         # [W, 4]
            sf_start = sf_start_all[c][ok][order]
            sf_pos = None
            last = -10 ** 9
            for w, t in enumerate(positions.tolist()):
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    continue
                last = t
                for ts in range(4):
                    s = int(sf_start[w][ts])
                    if s >= 0:
                        sf_pos = s
                    # -1 = superframe position unresolved (no ISCH
                    # location word seen yet): scrambled bursts cannot
                    # be descrambled or blind-accumulated at a guessed
                    # position (the serial guard skips sf_pos=None)
                    p = sf_pos if sf_pos is not None else -1
                    if sf_pos is not None:
                        sf_pos = (sf_pos + 1) % 12
                    d = int(duids_v[w][ts])
                    if d in self.XCCH_DUIDS:
                        j_ch.append(c)
                        j_tpos.append(t + n_pat + TS_DIBITS * ts)
                        j_sf.append(p)
                        j_duid.append(d)
                        j_slot.append(ts % 2)
        if not j_ch:
            return tuple(np.zeros(0, np.int32) for _ in range(5))
        return tuple(np.asarray(a, np.int32)
                     for a in (j_ch, j_tpos, j_sf, j_duid, j_slot))

    def _scramble_table(self, key) -> np.ndarray:
        tbl = self._scr_tables.get(key)
        if tbl is None:
            from dsdneo_tpu.protocol.p25 import p2_xcch
            tbl = p2_xcch.generate_scramble_bits(*key, 12 * 360 + 380)
            self._scr_tables[key] = tbl
        return tbl

    def decode_block_events(self, iq) -> int:
        """One [C, B] block end to end; events land in
        ``self.ctxs[c].events``.  Returns the number of MAC PDUs
        parsed."""
        return self.events_from_frontend(
            self.frontend_finish(self.frontend_dispatch(iq)))

    def events_from_frontend(self, fe6) -> int:
        from dsdneo_tpu.protocol.p25 import p2_xcch
        dibits_dev, idx, vq, duid, isch, n_sym = fe6
        ch, tpos, sfp, duidv, slotv = self.pick_xcch(idx, vq, duid,
                                                     isch, n_sym)
        N = ch.shape[0]
        if N == 0:
            return 0
        Np = -(-N // 64) * 64
        chp = np.full(Np, self.C, dtype=np.int32)
        chp[:N] = ch
        tpp = np.zeros(Np, dtype=np.int32)
        tpp[:N] = tpos
        packed = np.asarray(p2_xcch_gather_device(
            dibits_dev, jnp.asarray(chp), jnp.asarray(tpp)))[:N]
        bits = np.unpackbits(packed, axis=1)   # [N, 360]
        raw = bits.copy()                      # serial-fallback input
        # descramble (vectorized): per-channel LFSR table at each ts's
        # superframe position (+20 bit alignment, phase2._descramble).
        # Per-burst flags come from 16-entry DUID LUTs and the masks
        # are built with one fancy-gather per distinct scramble key —
        # the per-burst Python loop cost ~100 ms/block at fleet scale.
        duid_arr = np.asarray(duidv)
        scr_lut = np.zeros(16, dtype=bool)
        kind_lut = np.zeros(16, dtype=np.int8)
        for d, (kind, scr, _l) in self.XCCH_DUIDS.items():
            scr_lut[d] = scr
            kind_lut[d] = 0 if kind == "sacch" else 1
        scrambled = scr_lut[duid_arr]
        ch_np = np.asarray(ch)
        sfp_np = np.asarray(sfp)
        keys = [(c.state.p2_wacn, c.state.p2_sysid, c.state.p2_cc)
                for c in self.ctxs]
        key_ok = np.asarray([all(k) for k in keys], dtype=bool)
        have = key_ok[ch_np] & (~scrambled | (sfp_np >= 0))
        mask = np.zeros_like(bits)
        need = scrambled & have
        if need.any():
            uniq: dict = {}
            gid = np.asarray([uniq.setdefault(k, len(uniq))
                              for k in keys], dtype=np.int32)
            bgid = gid[ch_np]
            off360 = np.arange(360)
            for key, g in uniq.items():
                if not all(key):
                    continue
                sel = need & (bgid == g)
                if not sel.any():
                    continue
                tbl = self._scramble_table(key)
                base = 360 * sfp_np[sel] + 20
                mask[sel] = tbl[base[:, None] + off360]
        x = bits ^ mask
        # two-matmul screen per kind: RS parity consistency + CRC12.
        # float32 matmuls: numpy routes them through BLAS while int32
        # takes the naive loop (measured 635 → ~35 ms per block at
        # N=23k); sums are ≤360 so float32 is exact.
        idxmap = _xcch_index_arrays()
        res_ok = np.zeros(N, dtype=bool)
        crc_okv = np.zeros(N, dtype=bool)
        kinds = kind_lut[duid_arr]
        for kb, kind in ((0, "sacch"), (1, "facch")):
            sel = np.flatnonzero(kinds == kb)
            if sel.size == 0:
                continue
            pay_i, par_i = idxmap[kind]
            pays = x[sel][:, pay_i].astype(np.uint8)
            pars = x[sel][:, par_i].astype(np.uint8)
            M = p2_xcch.xcch_encode_matrix(kind)
            res = (pays.astype(np.float32)
                   @ M.astype(np.float32)).astype(np.int32)
            res_ok[sel] = (res % 2 == pars).all(axis=1)
            nd = 168 if kind == "sacch" else 144
            T12 = p2_xcch.crc12_matrix(nd).astype(np.float32)
            crc = (pays[:, :nd].astype(np.float32)
                   @ T12).astype(np.int32) % 2
            crc_okv[sel] = ((crc ^ 1)                      # 0xFFF inv
                            == pays[:, nd:nd + 12]).all(axis=1)
        n_parsed = 0
        for i in range(N):
            c, t, p = int(ch[i]), int(tpos[i]), int(sfp[i])
            kind, scr, lcch = self.XCCH_DUIDS[int(duidv[i])]
            slot = int(slotv[i])
            ctx, dec = self.ctxs[c], self.decs[c]
            hit = framesync.SyncHit(pos=t, score=1.0, sync=self._hit_def)
            if scr and not have[i]:
                s = ctx.state
                if all((s.p2_wacn, s.p2_sysid, s.p2_cc)) and p >= 0:
                    # blind recovery succeeded EARLIER IN THIS BLOCK
                    # (have[] was computed before the loop): decode with
                    # the recovered parameters instead of re-solving the
                    # GF(2) seed and re-emitting the recovery event
                    dec.sf_pos = p
                    detail = dec._xcch(raw[i], 0, kind, scrambled=True,
                                       lcch=lcch, ctx=ctx,
                                       have_params=True, hit=hit,
                                       slot=slot)
                    if detail and "ERR" in detail:
                        self.crc_errors += 1
                    else:
                        n_parsed += 1
                    continue
                # blind scramble-seed recovery path (serial decoder
                # accumulates bursts; once solved, later blocks take
                # the fast screen).  Unresolved superframe position
                # (p < 0) sets sf_pos=None so the serial guard skips
                # accumulation instead of polluting seed recovery with
                # a wrong position.
                dec.sf_pos = p if p >= 0 else None
                dec._xcch(raw[i], 0, kind, scrambled=True, lcch=lcch,
                          ctx=ctx, have_params=False, hit=hit, slot=slot)
                continue
            if res_ok[i] and (lcch or crc_okv[i]):
                pay_i, _ = idxmap[kind]
                n_parsed += 1
                self._parse_mac(c, t, kind, x[i][pay_i], slot, dec)
            else:
                # channel errors: serial RS(63,35) erasure decode
                self.rs_fallbacks += 1
                dec.sf_pos = p if p >= 0 else None
                detail = dec._xcch(raw[i], 0, kind, scrambled=scr,
                                   lcch=lcch, ctx=ctx, have_params=True,
                                   hit=hit, slot=slot)
                if detail and "ERR" in detail:
                    self.crc_errors += 1
                else:
                    n_parsed += 1
        return n_parsed

    def _parse_mac(self, c: int, t: int, kind: str, payload: np.ndarray,
                   slot: int, dec) -> None:
        """Host MAC-PDU walk of one clean xCCH payload, with the
        payload-keyed parse cache (control channels repeat ALOHA/iden
        spam many times per second; see BatchedP25ControlPipeline)."""
        ctx = self.ctxs[c]
        iden_v = getattr(getattr(ctx.state, "iden_table", None),
                         "version", 0)
        key = (payload.tobytes(), kind, slot & 1, iden_v)
        hit = framesync.SyncHit(pos=t, score=1.0, sync=self._hit_def)
        if self.parse_cache:
            hitv = self._pcache[c].get(key)
            if hitv is not None:
                for line, fields in hitv:
                    ctx.emit(line, "p25p2", t, **fields)
                return
        n0 = len(ctx.events)
        detail = dec._mac_pdu(payload, kind, ctx, hit, slot)
        name = {"sacch": "SACCH", "facch": "FACCH"}[kind]
        ctx.emit(f"       P25p2 {name}{detail}", "p25p2", t, slot=slot)
        if self.parse_cache:
            pc = self._pcache[c]
            if len(pc) >= 4096:
                pc.clear()
            pc[key] = [(e.line, dict(e.fields))
                       for e in ctx.events[n0:]]

    def events(self, c: int):
        return self.ctxs[c].events
