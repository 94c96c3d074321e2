"""Device-side (JAX/XLA) batched FEC kernels.

The batched device counterparts of the host decoders in
:mod:`dsdneo_tpu.fec.blockcodes` / :mod:`dsdneo_tpu.fec.trellis` /
:mod:`dsdneo_tpu.fec.rs`, built on the SAME codebooks and tables so the
two paths are bit-identical (asserted in tests/test_fec_device.py):

- **Codebook ML decode as one matmul**: a batch of soft words
  ``[N, n]`` correlates against the ±1 codebook ``[M, n]`` —
  exact soft-decision ML for every short block code the LMR protocols
  use (reference equivalents: src/fec/fec.c syndrome tables,
  include/dsd-neo/fec/Golay24.hpp, BCH_63_16.hpp).
- **Viterbi as lax.scan over [N, states] metric tensors** for the P25
  1/2-rate trellis (src/protocol/p25/p25_12.c) and the DMR 3/4 trellis
  (src/protocol/dmr/dmr_34_viterbi.c:364).
- **RS syndrome screen**: batched GF(2^6) syndrome evaluation flags the
  few words that need the host Berlekamp-Massey; clean words (the
  common case) bypass it entirely (include/dsd-neo/fec/ReedSolomon.hpp:62).
- **Batched IMBE voice-frame ECC**: deinterleave + Golay/PN/Hamming for
  ``[F, 144]`` frames in one jitted call (the per-frame host path is
  dsdneo_tpu.protocol.p25.imbe_frame.decode_imbe_ecc).

Everything here is shape-static and jit-compiled once per (code, batch
shape); int/bool lanes keep FEC exact on the float-preferring hardware.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.fec import blockcodes, trellis


# -- generic codebook ML ---------------------------------------------------
def ml_decode_batch(code: blockcodes.MLBlockCode, bits: jax.Array,
                    reliab: jax.Array | None = None
                    ) -> tuple[jax.Array, jax.Array]:
    """Batched exact-ML decode: ``bits`` [..., n] (0/1), optional
    ``reliab`` [..., n] ≥ 0 → (messages [...], bit error counts [...]).

    Matches MLBlockCode.decode_batch exactly: score = Σ reliab·(±1)·pm.
    """
    pm = jnp.asarray(code.pm)                       # [M, n] ±1
    cb = jnp.asarray(code.codebook)                 # [M, n] 0/1
    s = 1.0 - 2.0 * bits.astype(jnp.float32)
    if reliab is not None:
        s = s * (reliab.astype(jnp.float32) + 1e-3)  # host-identical weights
    # HIGHEST: a reduced-precision float32 matmul (TF32 on the GPU)
    # is exact for hard ±1 sums but quantizes away the +1e-3
    # reliability tie-break epsilon on the soft path, breaking the
    # documented host bit-identity
    scores = jnp.matmul(s, pm.T,
                        precision=jax.lax.Precision.HIGHEST)  # [..., M]
    m = jnp.argmax(scores, axis=-1)
    errs = jnp.sum(cb[m] != bits.astype(jnp.uint8), axis=-1)
    return m, errs


def _device_decoder(host_factory):
    """Bind a host codebook factory to a jitted batched device decoder."""
    @lru_cache(maxsize=None)
    def build():
        code = host_factory()

        @jax.jit
        def run(bits, reliab=None):
            return ml_decode_batch(code, bits, reliab)
        return run

    def decode(bits, reliab=None):
        return build()(jnp.asarray(bits), None if reliab is None
                       else jnp.asarray(reliab))
    return decode


golay_24_12_batch = _device_decoder(blockcodes.golay_24_12)
golay_20_8_batch = _device_decoder(blockcodes.golay_20_8)
golay_18_6_8_batch = _device_decoder(blockcodes.golay_18_6_8)
hamming_7_4_batch = _device_decoder(blockcodes.hamming_7_4)
hamming_12_8_batch = _device_decoder(blockcodes.hamming_12_8)
hamming_13_9_batch = _device_decoder(blockcodes.hamming_13_9)
hamming_15_11_batch = _device_decoder(blockcodes.hamming_15_11)
hamming_16_11_4_batch = _device_decoder(blockcodes.hamming_16_11_4)
hamming_10_6_3_batch = _device_decoder(blockcodes.hamming_10_6_3)
qr_16_7_6_batch = _device_decoder(blockcodes.qr_16_7_6)
bch_63_16_batch = _device_decoder(blockcodes.bch_63_16)


# -- P25 1/2-rate trellis Viterbi (lax.scan over [N, 4] metrics) -----------
@lru_cache(maxsize=1)
def _p25_trellis_consts():
    il = trellis.interleave_98()
    deperm = np.zeros(196, dtype=np.int32)
    deperm[il * 2] = np.arange(0, 196, 2)
    deperm[il * 2 + 1] = np.arange(1, 196, 2)
    expect = trellis.P25_DTM[(np.arange(4)[:, None] << 2)
                             | np.arange(4)[None, :]]        # [prev, next]
    nibbles = ((np.arange(16)[:, None] >> np.arange(3, -1, -1)[None, :]) & 1)
    return deperm, expect.astype(np.int32), nibbles.astype(np.int32)


@jax.jit
def p25_12_decode_batch(bits196: jax.Array, llr196: jax.Array | None = None
                        ) -> tuple[jax.Array, jax.Array]:
    """Batched P25 1/2-rate trellis decode: [N, 196] → ([N, 96] data
    bits, [N] path costs).  Identical lattice/tie-breaking to the host
    trellis.p25_12_decode (strict-less updates keep the lowest prev
    state on ties, matching numpy argmin).

    Layout: the batch axis N is the minor dimension ([4, N] /
    [16, N] tensors), and the 4-state min/argmin is a fully unrolled
    chain of elementwise selects instead of an [N, 4] gather/argmin."""
    deperm, expect, nibbles = _p25_trellis_consts()
    if llr196 is None:
        llr196 = (1 - 2 * bits196.astype(jnp.int32)) * 64
    llr = llr196[:, jnp.asarray(deperm)].astype(jnp.int32)   # deinterleave
    steps = llr.reshape(-1, 49, 4)
    pos = jnp.maximum(steps, 0)
    neg = jnp.maximum(-steps, 0)
    nib = jnp.asarray(nibbles)                               # [16, 4]
    cost_t = (nib[None, None] * pos[:, :, None, :]
              + (1 - nib[None, None]) * neg[:, :, None, :]).sum(-1)  # [N,49,16]
    cost_T = jnp.transpose(cost_t, (1, 2, 0))                # [49, 16, N]

    N = bits196.shape[0]
    # derive the init from the input (+0·x) so the scan carry inherits
    # the input's varying manual axes under shard_map (scan-vma rule)
    metric0 = (jnp.array([0, 256, 256, 256], dtype=jnp.int32)[:, None]
               + 0 * llr[:, :1].T)
    metric0 = jnp.broadcast_to(metric0, (4, N))

    def body(metric, cost_i):            # metric [4, N], cost_i [16, N]
        news, bps = [], []
        for nxt in range(4):
            best_v = metric[0] + cost_i[int(expect[0, nxt])]
            best_i = jnp.zeros_like(best_v, jnp.int8)
            for prev in range(1, 4):
                v = metric[prev] + cost_i[int(expect[prev, nxt])]
                take = v < best_v
                best_v = jnp.where(take, v, best_v)
                best_i = jnp.where(take, jnp.int8(prev), best_i)
            news.append(best_v)
            bps.append(best_i)
        return jnp.stack(news), jnp.stack(bps)               # [4, N] each

    metric, bps = jax.lax.scan(body, metric0, cost_T, unroll=7)
    best_v = metric[0]
    st = jnp.zeros_like(best_v, jnp.int32)
    for k in range(1, 4):
        take = metric[k] < best_v
        best_v = jnp.where(take, metric[k], best_v)
        st = jnp.where(take, jnp.int32(k), st)
    cost = best_v

    def back(st, bp):                    # bp [4, N]
        prev = jnp.zeros_like(st)
        for k in range(4):
            prev = jnp.where(st == k, bp[k].astype(jnp.int32), prev)
        return prev, st

    _, states = jax.lax.scan(back, st, bps, reverse=True,
                             unroll=7)                       # [49, N]
    data = jnp.swapaxes(states[:48], 0, 1)                   # [N, 48] dibits
    bits = jnp.zeros((N, 96), dtype=jnp.uint8)
    bits = bits.at[:, 0::2].set(((data >> 1) & 1).astype(jnp.uint8))
    bits = bits.at[:, 1::2].set((data & 1).astype(jnp.uint8))
    return bits, cost


# -- K=5 rate-1/2 convolutional Viterbi (NXDN FACCH/CAC/SACCH) -------------
@jax.jit
def conv_k5_decode_batch(sym: jax.Array, wt: jax.Array) -> jax.Array:
    """Batched K=5 rate-1/2 Viterbi: [N, 2n] soft symbols (values in
    [0, 1]) + per-symbol weights (0 = punctured) → [N, n] decoded bits
    (flush bits included; callers slice).  Identical lattice and
    tie-breaking to the host fec.conv.decode_soft (strict-less keeps
    the t>>1 predecessor on ties).  Lane-major like
    p25_12_decode_batch: the batch axis N is the minor dimension."""
    from dsdneo_tpu.fec.conv import _O1, _O2
    n = sym.shape[1] // 2
    s0 = jnp.transpose(sym[:, 0::2].astype(jnp.float32))     # [n, N]
    s1 = jnp.transpose(sym[:, 1::2].astype(jnp.float32))
    w0 = jnp.transpose(wt[:, 0::2].astype(jnp.float32))
    w1 = jnp.transpose(wt[:, 1::2].astype(jnp.float32))
    N = sym.shape[0]
    INF = jnp.float32(1e30)
    metric0 = jnp.where(jnp.arange(16)[:, None] == 0, 0.0, INF)
    metric0 = jnp.broadcast_to(metric0, (16, N)).astype(jnp.float32)
    # tie the carry init to the (device-varying) input so the scan
    # carry types match under shard_map (folded away by XLA otherwise)
    metric0 = metric0 + 0.0 * s0[0]

    def body(metric, x):
        s0i, s1i, w0i, w1i = x
        news, bps = [], []
        for t in range(16):
            pa, pb = t >> 1, (t >> 1) | 8
            b = t & 1
            ca = metric[pa] + (jnp.abs(float(_O1[pa, b]) - s0i) * w0i
                               + jnp.abs(float(_O2[pa, b]) - s1i) * w1i)
            cb = metric[pb] + (jnp.abs(float(_O1[pb, b]) - s0i) * w0i
                               + jnp.abs(float(_O2[pb, b]) - s1i) * w1i)
            take_b = cb < ca
            news.append(jnp.where(take_b, cb, ca))
            bps.append(jnp.where(take_b, jnp.int8(pb), jnp.int8(pa)))
        return jnp.stack(news), jnp.stack(bps)

    _metric, bps = jax.lax.scan(body, metric0, (s0, s1, w0, w1),
                                unroll=5)                    # bps [n,16,N]

    # flushed end state (input-tied like metric0 for shard_map)
    st0 = jnp.zeros(N, jnp.int32) + 0 * bps[-1, 0].astype(jnp.int32)

    def back(st, bp):                      # bp [16, N]
        bit = (st & 1).astype(jnp.uint8)
        prev = jnp.zeros_like(st)
        for k in range(16):
            prev = jnp.where(st == k, bp[k].astype(jnp.int32), prev)
        return prev, bit

    _, bits = jax.lax.scan(back, st0, bps, reverse=True, unroll=5)
    return jnp.transpose(bits)             # [N, n]


def conv_k3_decode_batch(bits: jax.Array) -> jax.Array:
    """Batched K=3 rate-1/2 Viterbi over HARD bits for the D-STAR RF
    header (reference src/protocol/dstar/dstar_header_utils.c
    dstar_header_viterbi_decode_soft; host parity
    protocol/dstar/decoder._viterbi_k3): [N, 2n] → [N, n] info bits.
    Identical lattice and tie-breaks (``<=`` keeps the ``ns>>1``
    predecessor; the end state is the first metric argmin, matching
    np.argmin).  Lane-major: the batch axis N is the minor dimension."""
    n = bits.shape[1] // 2
    s1 = jnp.transpose(bits[:, 0::2].astype(jnp.float32))   # [n, N]
    s0 = jnp.transpose(bits[:, 1::2].astype(jnp.float32))
    N = bits.shape[0]
    metric0 = jnp.zeros((4, N), jnp.float32)   # host decoder starts at 0
    trans = {0: ((0, 0, 0), (2, 1, 1)), 1: ((0, 1, 1), (2, 0, 0)),
             2: ((1, 1, 0), (3, 0, 1)), 3: ((1, 0, 1), (3, 1, 0))}

    def body(metric, x):
        s1i, s0i = x
        news, bps = [], []
        for ns in range(4):
            (pa, a1, a0), (pb, b1, b0) = trans[ns]
            ma = metric[pa] + jnp.abs(s1i - a1) + jnp.abs(s0i - a0)
            mb = metric[pb] + jnp.abs(s1i - b1) + jnp.abs(s0i - b0)
            take_b = mb < ma
            news.append(jnp.where(take_b, mb, ma))
            bps.append(take_b)
        return jnp.stack(news), jnp.stack(bps)

    metric, bps = jax.lax.scan(body, metric0, (s1, s0), unroll=6)
    st0 = jnp.argmin(metric, axis=0).astype(jnp.int32)

    def back(st, bp):                          # bp [4, N] bool
        bit = (st & 1).astype(jnp.uint8)
        mem = jnp.take_along_axis(bp, st[None, :], axis=0)[0]
        prev = (st >> 1) + 2 * mem.astype(jnp.int32)
        return prev, bit

    _, outs = jax.lax.scan(back, st0, bps, reverse=True, unroll=6)
    return jnp.transpose(outs)                 # [N, n]


# -- RS syndrome screen ----------------------------------------------------
@lru_cache(maxsize=None)
def _rs_syndrome_fn(nroots: int, fcr: int):
    from dsdneo_tpu.fec.rs import rs_24_12_13
    f = rs_24_12_13().f              # the shared GF(64) field
    exp_t = jnp.asarray(f.exp_table.astype(np.int32))
    log_t = jnp.asarray(f.log_table.astype(np.int32))
    q1 = f.q - 1

    @jax.jit
    def syndromes(words):            # [N, n] int32 symbols
        n = words.shape[1]
        deg = jnp.arange(n - 1, -1, -1, dtype=jnp.int32)     # r[0] = high
        nz = words != 0
        logw = log_t[words]

        def one(i, acc):
            term_log = (logw + deg * (fcr + i)) % q1
            vals = jnp.where(nz, exp_t[term_log], 0)
            # GF(2^6) sum is XOR, not +
            s = jax.lax.reduce(vals, np.int32(0),
                               jax.lax.bitwise_xor, dimensions=[1])
            return acc.at[:, i].set(s)

        N = words.shape[0]
        acc = jnp.zeros((N, nroots), dtype=jnp.int32)
        acc = jax.lax.fori_loop(0, nroots, one, acc)
        return acc
    return syndromes


def rs_syndromes_batch(words: np.ndarray, nroots: int, fcr: int = 1
                       ) -> np.ndarray:
    """Batched GF(2^6) syndromes: [N, n] symbol words → [N, nroots].
    All-zero syndromes ⇒ clean codeword (skip host Berlekamp-Massey).

    GF(64)-ONLY (the shared RS-63 family field): a GF(256) code like
    DMR's RS(12,9) would silently index past the 64-entry log table
    (JAX clamps gathers instead of raising), so symbols are validated
    here."""
    w = np.asarray(words, dtype=np.int32)
    if w.size and int(w.max()) >= 64:
        raise ValueError(
            "rs_syndromes_batch covers the GF(2^6) RS-63 family only; "
            f"got symbol {int(w.max())} >= 64 (GF(256) codes such as "
            "RS(12,9) need their own field tables)")
    return np.asarray(_rs_syndrome_fn(nroots, fcr)(jnp.asarray(w)))



def _ml_golay_dec(words, pm, cb):
    """Shared ML Golay(23,12) correlate-and-count used by all three
    voice-frame ECC kernels (IMBE, DMR AMBE, D-STAR AMBE): [F, 23]
    hard bits -> (message index, bit error count).  HIGHEST precision
    keeps the +-1 correlation in full float32 (see ml_decode_batch)."""
    s = 1.0 - 2.0 * words.astype(jnp.float32)
    m = jnp.argmax(jnp.matmul(s, pm.T,
                              precision=jax.lax.Precision.HIGHEST),
                   axis=-1)
    errs = jnp.sum(cb[m] != words, axis=-1)
    return m, errs


# -- batched IMBE voice-frame ECC -------------------------------------------
@lru_cache(maxsize=1)
def _imbe_consts():
    from dsdneo_tpu.protocol.p25 import imbe_frame as IF
    # deinterleave gather: row-major [8, 23] frame ← 144 on-air bits
    gather = np.zeros((8, 23), dtype=np.int32)
    for j in range(72):
        gather[IF.IMBE_W[j], IF.IMBE_X[j]] = 2 * j
        gather[IF.IMBE_Y[j], IF.IMBE_Z[j]] = 2 * j + 1
    # PN table: seed (12-bit) → 114 PN bits
    pn = np.zeros((4096, 114), dtype=np.uint8)
    for s in range(4096):
        pn[s] = IF._pn_bits(s, 114)
    g23 = IF.golay_23_12()
    # u0 codeword → seed value (bits [11..22] LSB-first)
    seed_of_msg = np.zeros(4096, dtype=np.int32)
    for m in range(4096):
        c = g23.codebook[m]
        seed_of_msg[m] = sum(int(c[11 + i]) << i for i in range(12))
    # param bits of each message: golay rows → c[22..11]
    param_g = g23.codebook[:, 22:10:-1].astype(np.uint8)     # [4096, 12]
    h15 = blockcodes_h15_codebook()
    param_h = h15[:, 14:3:-1].astype(np.uint8)               # [2048, 11]
    return gather, pn, seed_of_msg, param_g, param_h, g23


@lru_cache(maxsize=1)
def blockcodes_h15_codebook() -> np.ndarray:
    """Codebook of the learned IMBE Hamming(15,11) (systematic, data at
    positions 4-14, parity at 0-3), indexed by the 11 data bits."""
    from dsdneo_tpu.protocol.p25 import imbe_frame as IF
    cb = np.zeros((2048, 15), dtype=np.uint8)
    for m in range(2048):
        d = np.array([(m >> (10 - i)) & 1 for i in range(11)], dtype=np.uint8)
        cb[m] = IF._imbe_hamming_encode(d)
    return cb


@lru_cache(maxsize=1)
def _imbe_ecc_jit():
    gather, pn, seed_of_msg, param_g, param_h, g23 = _imbe_consts()
    from dsdneo_tpu.protocol.p25 import imbe_frame as IF
    h15 = blockcodes_h15_codebook()
    # numpy-only in the closure: this cache outlives any single trace,
    # and jnp constants created while tracing an OUTER jit (e.g.
    # voice_decode_device) would leak that trace's tracers
    pm_g_n = (1.0 - 2.0 * g23.codebook).astype(np.float32)
    cb_g_n = g23.codebook
    pm_h_n = (1.0 - 2.0 * h15).astype(np.float32)
    cb_h_n = h15
    gth_n = gather.reshape(-1)
    pn_n, seed_n, pg_n, ph_n = pn, seed_of_msg, param_g, param_h

    @jax.jit
    def run(bits144):                 # [F, 144] uint8
        pm_g, cb_g = jnp.asarray(pm_g_n), jnp.asarray(cb_g_n)
        pm_h, cb_h = jnp.asarray(pm_h_n), jnp.asarray(cb_h_n)
        gth, pn_t = jnp.asarray(gth_n), jnp.asarray(pn_n)
        seed_t, pg, ph = (jnp.asarray(seed_n), jnp.asarray(pg_n),
                          jnp.asarray(ph_n))
        F = bits144.shape[0]
        fr = bits144[:, gth].reshape(F, 8, 23)               # [F, 8, 23]

        def golay_dec(words):         # [F, 23] → (msg, errs)
            return _ml_golay_dec(words, pm_g, cb_g)

        m0, e0 = golay_dec(fr[:, 0])
        seed = seed_t[m0]
        pnb = pn_t[seed]                                      # [F, 114]
        out = jnp.zeros((F, 88), dtype=jnp.uint8)
        out = out.at[:, 0:12].set(pg[m0])
        errs = e0.astype(jnp.int32)
        pos = 0
        k = 12
        for row in range(1, 4):
            w = fr[:, row] ^ pnb[:, pos:pos + 23][:, ::-1]
            pos += 23
            m, e = golay_dec(w)
            errs += e.astype(jnp.int32)
            out = out.at[:, k:k + 12].set(pg[m])
            k += 12
        for row in range(4, 7):
            w = fr[:, row, :15] ^ pnb[:, pos:pos + 15][:, ::-1]
            pos += 15
            s = 1.0 - 2.0 * w.astype(jnp.float32)
            m = jnp.argmax(jnp.matmul(s, pm_h.T,
                                      precision=jax.lax.Precision.HIGHEST),
                           axis=-1)
            e = jnp.sum(cb_h[m] != w, axis=-1)
            errs += e.astype(jnp.int32)
            out = out.at[:, k:k + 11].set(ph[m])
            k += 11
        out = out.at[:, k:k + 7].set(fr[:, 7, 6::-1])
        return out, errs
    return run


def imbe_ecc_batch(bits144: np.ndarray) -> tuple[jax.Array, jax.Array]:
    """Batched IMBE voice-frame ECC: [F, 144] on-air bits →
    ([F, 88] parameter bits, [F] error counts), one jitted device call.

    NOTE: the Hamming rows use exact-ML codebook decode (≤1-bit-error
    behavior identical to the host syndrome decode; ≥2-bit errors decode
    to the nearest codeword instead of being flagged, which can differ
    from the host's corrections counter by design)."""
    if isinstance(bits144, jax.core.Tracer) or isinstance(bits144, jax.Array):
        x = bits144.astype(jnp.uint8)       # already traced / on device
    else:
        x = jnp.asarray(np.asarray(bits144, dtype=np.uint8))
    return _imbe_ecc_jit()(x)


# -- AMBE+2 voice-frame ECC (DMR/NXDN/dPMR/YSF/P25p2/X2) --------------------

@lru_cache(maxsize=1)
def _ambe_consts():
    """Constant tables for the batched AMBE ECC: the on-air dibit
    de-interleave gather, the Golay(23,12) codebook, and the per-C0
    PN scramble rows (the 173x+13849 recurrence seeded by the corrected
    C0 bits [12..24) LSB-first incl. parity — protocol behavior
    recovered in protocol/dmr/ambe_frame.py)."""
    from dsdneo_tpu.protocol.dmr.ambe_frame import AMBE_MAP
    from dsdneo_tpu.protocol.p25.imbe_frame import _pn_bits, golay_23_12
    g23 = golay_23_12()
    # gather[r, c] = index into the 72 on-air bits for fr[r][c]
    gather = np.zeros((4, 24), dtype=np.int32)
    for j, (hr, hc, lr, lc) in enumerate(AMBE_MAP):
        gather[hr, hc] = 2 * j
        gather[lr, lc] = 2 * j + 1
    # PN row + parity per possible C0 message
    pn_of_msg = np.zeros((4096, 23), dtype=np.uint8)
    parity_of_msg = np.zeros(4096, dtype=np.uint8)
    param_of_msg = np.zeros((4096, 12), dtype=np.uint8)
    for m in range(4096):
        cw = g23.codebook[m]
        par = int(cw.sum()) & 1
        foo = 0
        for k in range(11):
            foo |= int(cw[12 + k]) << k
        foo |= par << 11
        pn_of_msg[m] = _pn_bits(foo, 23)[::-1]
        parity_of_msg[m] = par
        for i in range(12):
            param_of_msg[m, i] = (m >> (11 - i)) & 1
    return gather, g23, pn_of_msg, parity_of_msg, param_of_msg


@lru_cache(maxsize=1)
def _ambe_ecc_jit():
    gather, g23, pn_of_msg, parity_of_msg, param_of_msg = _ambe_consts()
    pm_n = (1.0 - 2.0 * g23.codebook).astype(np.float32)
    cb_n = g23.codebook
    gth_n = gather.reshape(-1)

    @jax.jit
    def run(bits72):                  # [F, 72] uint8
        pm, cb = jnp.asarray(pm_n), jnp.asarray(cb_n)
        pn_t = jnp.asarray(pn_of_msg)
        par_t = jnp.asarray(parity_of_msg)
        prm = jnp.asarray(param_of_msg)
        F = bits72.shape[0]
        fr = bits72[:, jnp.asarray(gth_n)].reshape(F, 4, 24)

        def golay_dec(words):
            return _ml_golay_dec(words, pm, cb)

        m0, e0 = golay_dec(fr[:, 0, :23])
        errs = e0.astype(jnp.int32)
        errs += (par_t[m0] != fr[:, 0, 23]).astype(jnp.int32)
        m1, e1 = golay_dec(fr[:, 1, :23] ^ pn_t[m0])
        errs += e1.astype(jnp.int32)
        out = jnp.concatenate(
            [prm[m0], prm[m1], fr[:, 2, :11], fr[:, 3, :14]], axis=1)
        return out.astype(jnp.uint8), errs
    return run


def ambe_ecc_batch(bits72) -> tuple[jax.Array, jax.Array]:
    """Batched AMBE+2 voice-frame ECC: [F, 72] on-air bits →
    ([F, 49] parameter bits, [F] error counts); device equivalent of
    protocol/dmr/ambe_frame.decode_ambe_ecc."""
    if isinstance(bits72, (jax.core.Tracer, jax.Array)):
        x = bits72.astype(jnp.uint8)
    else:
        x = jnp.asarray(np.asarray(bits72, dtype=np.uint8))
    return _ambe_ecc_jit()(x)


# -- D-STAR AMBE 3600x2400 voice-frame ECC ----------------------------------

@lru_cache(maxsize=1)
def _dstar_ambe_jit():
    """Constants + jitted kernel for the D-STAR AMBE variant
    (protocol/dstar/ambe2400.py): same dual-Golay + PN structure as
    AMBE+2 with the D-STAR w/x interleave, extended-Golay parity at
    fr[0][0], codeword at fr[0][1:24], seed from fr[0] bits [12..24)."""
    from dsdneo_tpu.protocol.dstar.ambe2400 import _row_positions, _seed12
    from dsdneo_tpu.protocol.p25.imbe_frame import _pn_bits, golay_23_12
    g23 = golay_23_12()
    r0, r1, r2, r3 = (r.astype(np.int32) for r in _row_positions())
    pn_of_msg = np.zeros((4096, 23), dtype=np.uint8)
    parity_of_msg = np.zeros(4096, dtype=np.uint8)
    param_of_msg = np.zeros((4096, 12), dtype=np.uint8)
    for m in range(4096):
        cw = g23.codebook[m]
        pn_of_msg[m] = _pn_bits(_seed12(cw), 23)[::-1]
        parity_of_msg[m] = int(cw.sum()) & 1
        for i in range(12):
            param_of_msg[m, i] = (m >> (11 - i)) & 1
    pm_n = (1.0 - 2.0 * g23.codebook).astype(np.float32)
    cb_n = g23.codebook

    @jax.jit
    def run(bits72):                  # [F, 72] uint8
        pm, cb = jnp.asarray(pm_n), jnp.asarray(cb_n)
        pn_t = jnp.asarray(pn_of_msg)
        par_t = jnp.asarray(parity_of_msg)
        prm = jnp.asarray(param_of_msg)
        fr0 = bits72[:, jnp.asarray(r0)]
        fr1 = bits72[:, jnp.asarray(r1)]
        fr2 = bits72[:, jnp.asarray(r2)]
        fr3 = bits72[:, jnp.asarray(r3)]

        def golay_dec(words):
            return _ml_golay_dec(words, pm, cb)

        m0, e0 = golay_dec(fr0[:, 1:24])
        errs = e0.astype(jnp.int32)
        errs += (par_t[m0] != fr0[:, 0]).astype(jnp.int32)
        m1, e1 = golay_dec(fr1 ^ pn_t[m0])
        errs += e1.astype(jnp.int32)
        out = jnp.concatenate([prm[m0], prm[m1], fr2, fr3], axis=1)
        return out.astype(jnp.uint8), errs
    return run


def dstar_ambe_ecc_batch(bits72) -> tuple[jax.Array, jax.Array]:
    """Batched D-STAR AMBE voice-frame ECC: [F, 72] on-air bits →
    ([F, 49] parameter bits, [F] error counts); device equivalent of
    protocol/dstar/ambe2400.decode_dstar_ambe_ecc."""
    if isinstance(bits72, (jax.core.Tracer, jax.Array)):
        x = bits72.astype(jnp.uint8)
    else:
        x = jnp.asarray(np.asarray(bits72, dtype=np.uint8))
    return _dstar_ambe_jit()(x)
