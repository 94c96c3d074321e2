"""Single-dispatch device voice decode: ECC'd parameter bits → PCM.

The batched pipeline's remaining host work (per-(L,K) amplitude
transforms, the inter-frame prediction recurrence, and the synth
upload/fetch round trips) all collapse into ONE jitted program here:

  [F, 88] parameter bits ──(scatter by channel/step)──►
  per-L table gather → dequant matmul → prediction lax.scan over time
  → harmonic synthesis → [C, T, 160] f16 PCM

K is a pure function of L (K = min((L+2)//3, 12)), so every per-(L,K)
table from :mod:`dsdneo_tpu.vocoder.batch` stacks into dense [48, ...]
constants indexed by L-9 on device — no data-dependent shapes.

Numerics match the host two-pass path (decode_transforms +
run_prediction + synth) to f32 rounding; asserted in
tests/test_voicebatch.py.

Reference behavior: the IMBE dequantizer contract of
mbelib/imbe7200x4400.c as recovered in vocoder/imbe.py (PARITY.md
"IMBE parameter-bit layout").
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.vocoder import imbe

MAX_L = imbe.MAX_L          # 56
L_MIN = 9
N_L = MAX_L - L_MIN + 1     # 48 distinct L groups
MAX_BITS = 70               # >= max amplitude bit count (73 - K_min)
MAX_VALS = 55               # 5 gain PRBA values + (L-6) DCT coeffs, L<=56


@lru_cache(maxsize=None)
def _stacked_tables():
    """Dense per-L constant tables, padded to fixed shapes:
    POS [N_L, MAX_BITS], W [N_L, MAX_BITS, MAX_VALS] (codes = bits @ W),
    STEPS/OFFS [N_L, MAX_VALS], A [N_L, MAX_VALS+1, MAX_L]
    (T = [G1, x] @ A)."""
    from dsdneo_tpu.vocoder.batch import _group_tables
    POS = np.zeros((N_L, MAX_BITS), dtype=np.int32)
    W = np.zeros((N_L, MAX_BITS, MAX_VALS), dtype=np.float32)
    STEPS = np.zeros((N_L, MAX_VALS), dtype=np.float32)
    OFFS = np.zeros((N_L, MAX_VALS), dtype=np.float32)
    A = np.zeros((N_L, MAX_VALS + 1, MAX_L), dtype=np.float32)
    for L in range(L_MIN, MAX_L + 1):
        K = min((L + 2) // 3, 12)
        pos, Wg, steps, offs, Ag = _group_tables(L, K)
        i = L - L_MIN
        nb, nv = len(pos), Wg.shape[0]
        POS[i, :nb] = pos
        W[i, :nb, :nv] = Wg.T
        STEPS[i, :nv] = steps
        OFFS[i, :nv] = offs
        # coef layout [G1, x...]: A row 0 is the G1 column of Ag
        A[i, 0, :L] = Ag[:, 0]
        A[i, 1:nv + 1, :L] = Ag[:, 1:].T
    return POS, W, STEPS, OFFS, A


def _headers(S):
    """[F, 88] float bits → (gain_code, b0, w0, L, K) on device,
    mirroring batch._extract_header + decode_transforms."""
    gshift = jnp.asarray([1 << (5 - i) for i in range(6)], jnp.float32)
    gain = S[:, jnp.asarray(imbe.GAIN_POS)] @ gshift
    bshift = jnp.asarray([1 << (7 - i) for i in range(6)], jnp.float32)
    b0 = S[:, jnp.asarray(imbe.B0_HI_POS)] @ bshift
    b0 += S[:, imbe.B0_LO_POS[0]] * 2.0 + S[:, imbe.B0_LO_POS[1]]
    b0c = jnp.clip(b0, 0.0, 207.0)
    w0 = 4.0 * jnp.pi / (b0c + 39.5)
    # host: L = int(0.9254 * int(pi/w0 + 0.25))
    L = jnp.floor(0.9254 * jnp.floor(jnp.pi / w0 + 0.25)).astype(jnp.int32)
    L = jnp.clip(L, L_MIN, MAX_L)
    K = jnp.minimum((L + 2) // 3, 12)
    return gain, w0, L, K


def _transforms(S):
    """[F, 88] bits → (T_full [F, MAX_L], w0 [F], L [F], K [F]):
    device equivalent of batch.decode_transforms."""
    POS, W, STEPS, OFFS, A = (jnp.asarray(t) for t in _stacked_tables())
    Sf = S.astype(jnp.float32)
    gain, w0, L, K = _headers(Sf)
    li = L - L_MIN                                        # [F] table index
    bits = jnp.take_along_axis(Sf, POS[li], axis=1)       # [F, MAX_BITS]
    codes = jnp.einsum("fb,fbv->fv", bits, W[li],
                       precision=jax.lax.Precision.HIGHEST)     # [F, MAX_VALS]
    x = (codes - OFFS[li]) * STEPS[li]
    G1 = imbe.GAIN_MIN + gain * imbe.GAIN_STEP
    coef = jnp.concatenate([G1[:, None], x], axis=1)      # [F, MAX_VALS+1]
    T = jnp.einsum("fc,fcl->fl", coef, A[li],
                   precision=jax.lax.Precision.HIGHEST)         # [F, MAX_L]
    return T, w0, L, K


def _prediction_scan(T, w0, L, K, V, act, prev_logm, prev_L):
    """lax.scan over time of the inter-frame log-amplitude prediction
    (device equivalent of batch.run_prediction).  Inputs are [C, T_n,
    ...] scattered arrays; V is the 12 voicing band bits [C, T_n, 12].
    Returns (w0s, voiced, amps) [C, T_n, ...] and final state."""
    lidx = jnp.arange(1, MAX_L + 1, dtype=jnp.float32)[None, :]   # [1, L]

    def body(carry, xs):
        p_logm, p_L = carry
        T_t, w0_t, L_t, K_t, V_t, a_t = xs
        Lf = L_t.astype(jnp.float32)[:, None]
        pl = p_L.astype(jnp.float32)[:, None]
        k = jnp.where(pl > 0, lidx * pl / jnp.maximum(Lf, 1.0), 1.0) - 1.0
        kmax = jnp.maximum(p_L - 1, 0)[:, None]
        k0 = jnp.clip(jnp.floor(k).astype(jnp.int32), 0, kmax)
        k1 = jnp.minimum(k0 + 1, kmax)
        frac = jnp.clip(k - k0, 0.0, 1.0)
        g0 = jnp.take_along_axis(p_logm, k0, axis=1)
        g1 = jnp.take_along_axis(p_logm, k1, axis=1)
        pred_full = (1.0 - frac) * g0 + frac * g1
        mask = (lidx <= Lf).astype(jnp.float32)
        pvalid = pred_full * mask
        pmean = pvalid.sum(axis=1, keepdims=True) / jnp.maximum(Lf, 1.0)
        pred = imbe.PRED_DECAY * (pvalid - pmean) * mask
        has_prev = (p_L > 0)[:, None]
        logm = (T_t + jnp.where(has_prev, pred, 0.0)) * mask

        band = jnp.minimum((jnp.arange(MAX_L)[None, :] // 3),
                           (K_t - 1)[:, None])
        v = jnp.take_along_axis(V_t, band, axis=1) * mask

        am = a_t[:, None].astype(jnp.float32)
        n_logm = jnp.where(am > 0, logm, p_logm)
        n_L = jnp.where(a_t > 0, L_t, p_L)
        from dsdneo_tpu.vocoder.mbe import _IMBE_AMP_SCALE
        amps = (jnp.exp2(jnp.clip(logm, -4.0, 14.0)) * mask
                * _IMBE_AMP_SCALE) * am
        return (n_logm, n_L), (w0_t * a_t, v * am, amps)

    xs = tuple(jnp.swapaxes(a, 0, 1) for a in (T, w0, L, K, V, act))
    # the per-step body is tiny ([C, 56] elementwise + two gathers), so
    # the scan is kernel-launch-bound: unrolling 9 steps (n_steps pads
    # to multiples of 27) amortizes the dispatch overhead
    (f_logm, f_L), (w0s, voiced, amps) = jax.lax.scan(
        body, (prev_logm, prev_L), xs, unroll=9)
    return (jnp.swapaxes(w0s, 0, 1), jnp.swapaxes(voiced, 0, 1),
            jnp.swapaxes(amps, 0, 1), f_logm, f_L)


def _decode_from_frames(frames144, fch, forder, prev_logm, prev_L,
                        C: int, n_steps: int, pcm_fmt: str = "f16",
                        prev_synth=None, rep_state=None):
    """Traced body shared by voice_decode_device (host-gathered frames)
    and voice_decode_gather (device-gathered frames).  ``prev_synth``
    is the per-channel synthesis carry (theta [C], w [C], amps
    [C, MAX_L]) from the previous block, so a talker spanning block
    boundaries synthesizes without a phase/amplitude seam (the
    reference's mbelib keeps its oscillator state across calls);
    ``rep_state`` is the frame-repeat carry (repeat_gate) so corrupt
    frames re-use the last good parameters up to MAX_REPEAT times
    before muting (dsd_mbe.c store_process_result semantics)."""
    from dsdneo_tpu.fec.device import imbe_ecc_batch
    from dsdneo_tpu.vocoder.synth import synthesize_stream

    bits88, errs = imbe_ecc_batch(frames144)              # [F, 88]
    T, w0, L, K = _transforms(bits88)
    V = bits88[:, imbe.VOICING_START:imbe.VOICING_START + 12
               ].astype(jnp.float32)                       # [F, 12]
    good = imbe_frame_good(bits88, errs)                   # [F] 0/1

    # scatter frames to [C+1, n_steps, ...] (row C swallows padding)
    def scat(vals, shape, dtype):
        z = jnp.zeros((C + 1, n_steps) + shape, dtype)
        return z.at[fch, forder].set(vals.astype(dtype))[:C]

    Ts = scat(T, (MAX_L,), jnp.float32)
    w0s = scat(w0, (), jnp.float32)
    Ls = scat(L, (), jnp.int32)
    Ks = jnp.maximum(scat(K, (), jnp.int32), 1)
    Vs = scat(V, (12,), jnp.float32)
    act = scat(good, (), jnp.float32)

    w0o, voiced, amps, f_logm, f_L = _prediction_scan(
        Ts, w0s, jnp.maximum(Ls, 1), Ks, Vs, act, prev_logm, prev_L)

    # clean tone codes synthesize single-harmonic tones on device
    # (host path: vocoder.glue tone contract); they don't touch the
    # prediction state (act=0 already froze it above)
    is_tone, w0_t, amp_t = imbe_tone_params(bits88)
    tone_f = (is_tone & (errs <= 5)).astype(jnp.float32)
    tones = scat(tone_f, (), jnp.float32)
    w0_ts = scat(w0_t * tone_f, (), jnp.float32)
    amp_ts = scat(amp_t * tone_f, (), jnp.float32)
    e0 = jnp.zeros((1, 1, MAX_L), jnp.float32).at[0, 0, 0].set(1.0)
    w0o = jnp.where(tones > 0, w0_ts, w0o)
    voiced = jnp.where(tones[:, :, None] > 0, e0, voiced)
    amps = jnp.where(tones[:, :, None] > 0,
                     e0 * (amp_ts * 0.5)[:, :, None], amps)

    # bounded frame repeat: present-but-corrupt steps re-use the last
    # good parameters (≤ MAX_REPEAT), then mute
    present = scat(jnp.ones_like(good), (), jnp.float32)
    if rep_state is None:
        rep_state = repeat_state_init(C)
    (w0o, voiced, amps), rep_out = repeat_gate(
        w0o, voiced, amps, jnp.maximum(act, tones), present, rep_state)

    F_ = n_steps
    noise = (jnp.mod(jnp.arange(C * F_ * MAX_L, dtype=jnp.float32)
                     * 2.399963, 2 * jnp.pi)).reshape(C, F_, MAX_L)
    if prev_synth is None:
        prev_synth = synth_state_init(C)
    pcm, t_out, w_out, a_out = jax.vmap(synthesize_stream)(
        w0o, amps, voiced, noise, *prev_synth)
    synth_out = (t_out, w_out, a_out)
    if pcm_fmt == "adpcm":
        # IMA ADPCM wire format (ops.audio_wire): 4 bits/sample,
        # halves the transfer again vs u-law
        from dsdneo_tpu.ops.audio_wire import adpcm_compress
        p = jnp.clip(pcm * 0.02, -1.0, 1.0)
        q = adpcm_compress(p.reshape(p.shape[0], -1))
        return q, f_logm, f_L, synth_out, rep_out
    if pcm_fmt == "mulaw":
        # G.711 u-law wire format (see engine.dmrbatch): halves the
        # transfer; fixed scale keeps the program data-independent
        p = jnp.clip(pcm * 0.02, -1.0, 1.0)
        y = jnp.sign(p) * jnp.log1p(255.0 * jnp.abs(p)) / np.log1p(255.0)
        q = jnp.clip((y + 1.0) * 127.5 + 0.5, 0, 255).astype(jnp.uint8)
        return q, f_logm, f_L, synth_out, rep_out
    return pcm.astype(jnp.float16), f_logm, f_L, synth_out, rep_out


@partial(jax.jit, static_argnames=("C", "n_steps"))
def voice_decode_device(frames144, fch, forder, prev_logm, prev_L,
                        C: int, n_steps: int, prev_synth=None,
                        rep_state=None):
    """[F, 144] interleaved voice-frame bits (+ their channel/time-step
    indices; pad frames use fch == C) → ([C, n_steps, 160] f16 PCM,
    final prediction state, synthesis carry, repeat carry).

    One device dispatch for ECC + dequant + prediction + synthesis —
    the production fast path of BatchedP25VoicePipeline.decode_block.
    """
    return _decode_from_frames(frames144, fch, forder, prev_logm, prev_L,
                               C, n_steps, prev_synth=prev_synth,
                               rep_state=rep_state)


@partial(jax.jit, static_argnames=("C", "n_steps", "pcm_fmt"))
def voice_decode_gather(dibits, ldu_ch, ldu_pos, offs, fch, forder,
                        prev_logm, prev_L, C: int, n_steps: int,
                        pcm_fmt: str = "f16", prev_synth=None,
                        rep_state=None):
    """Device-resident variant: the [C, T] dibit array never leaves the
    chip.  The host uploads only the accepted LDU list (ldu_ch/ldu_pos,
    padded with ldu_ch == C) and the per-frame channel/step indices; the
    9×72-dibit voice-frame gather (offs = status-stripped offsets
    relative to each LDU's sync position) runs here, then the same
    ECC → dequant → prediction → synthesis chain as
    voice_decode_device.  Kills the largest host←device transfer of the
    batched chain (the packed dibit blob)."""
    Tn = dibits.shape[1]
    pos = jnp.clip(ldu_pos[:, None, None] + offs[None], 0, Tn - 1)
    ch = jnp.minimum(ldu_ch, dibits.shape[0] - 1)
    dd = dibits[ch[:, None, None], pos]                  # [Lp, 9, 72]
    dd = dd.reshape(-1, 72)
    frames144 = jnp.zeros((dd.shape[0], 144), dtype=jnp.uint8)
    frames144 = frames144.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
    frames144 = frames144.at[:, 1::2].set((dd & 1).astype(jnp.uint8))
    return _decode_from_frames(frames144, fch, forder, prev_logm, prev_L,
                               C, n_steps, pcm_fmt, prev_synth=prev_synth,
                               rep_state=rep_state)


def imbe_frame_good(bits88, errs) -> "jax.Array":
    """Fleet-path voice-frame mask (the MBE glue contract,
    vocoder.glue): non-voice codes (raw b0 > 207) and frames whose ECC
    error count exceeds the IMBE threshold are excluded — act=0 also
    freezes the prediction state, like the host path's last-good
    discipline.  Excluded frames route through the device repeat gate
    (repeat_gate below): repeat the last good parameters up to
    MAX_REPEAT frames, then mute — and clean tone codes synthesize
    single-harmonic tones (imbe_tone_params)."""
    from dsdneo_tpu.vocoder.imbe import B0_HI_POS, B0_LO_POS
    hi = bits88[:, jnp.asarray(B0_HI_POS)].astype(jnp.int32)
    b0 = hi @ jnp.asarray([1 << (7 - i) for i in range(6)], jnp.int32)
    b0 = b0 | (bits88[:, B0_LO_POS[0]].astype(jnp.int32) << 1) \
            | bits88[:, B0_LO_POS[1]].astype(jnp.int32)
    return ((errs <= 5) & (b0 <= 207)).astype(jnp.float32)


def ambe_frame_mask(bits49, errs, thr: int = 3) -> "jax.Array":
    """AMBE fleet-path mute mask: tone frames (pitch field 0x7F with
    the tone ID repeated, see vocoder.glue.ambe_tone_info) and
    over-threshold frames are muted in the batched pipelines."""
    w7 = jnp.asarray([1 << (6 - i) for i in range(7)], jnp.int32)
    b0 = bits49[:, :7].astype(jnp.int32) @ w7
    id1 = bits49[:, 7:14].astype(jnp.int32) @ w7
    id2 = bits49[:, 21:28].astype(jnp.int32) @ w7
    tone = (b0 == 0x7F) & (id1 == id2)
    return ((errs <= thr) & ~tone).astype(jnp.float32)


# -- bounded frame repeat + device tone synthesis ----------------------------

MAX_REPEAT = 3          # vocoder.glue.MAX_REPEAT (dsd_mbe.c store_process_result)
TONE_FREQ_STEP_HZ = 31.25       # dsd_audio2.c soft_tonef
TONE_AMP_STEP = 75.0


def repeat_state_init(C: int):
    """Per-channel repeat-contract carry: (last-good w0, voiced, amps,
    repeats already consumed, carry-valid flag)."""
    return (jnp.zeros(C, jnp.float32),
            jnp.zeros((C, MAX_L), jnp.float32),
            jnp.zeros((C, MAX_L), jnp.float32),
            jnp.zeros(C, jnp.int32),
            jnp.zeros(C, jnp.float32))


def synth_state_init(C: int):
    """Per-channel synthesis carry (fundamental phase, last ω0/amps)."""
    return (jnp.zeros(C, jnp.float32), jnp.zeros(C, jnp.float32),
            jnp.zeros((C, MAX_L), jnp.float32))


def repeat_gate(w0s, Vs, As, good, present, state,
                max_repeat: int = MAX_REPEAT):
    """The bounded frame-repeat contract on scattered [C, T] parameter
    grids (vocoder.glue host semantics; reference dsd_mbe.c
    store_process_result): a present-but-corrupt step re-uses the last
    good frame's parameters, up to ``max_repeat`` consecutive corrupt
    frames, after which the stream mutes until a clean frame arrives.
    Absent steps (no frame decoded there — scatter padding) stay
    silent and do not advance the repeat count.

    Fully parallel (no scan): the last-good slot per step is a cummax
    over an extended [C, T+1] column whose slot 0 carries the previous
    block's last-good frame, and the consumed-repeat count is a cumsum
    of present-bad indicators differenced at the last-good slot.

    Returns ((w0r, Vr, Ar) [C, T(,L)] gated params, new state).
    """
    C, T = w0s.shape
    lw0, lV, lA, rep_in, valid_in = state
    goode = jnp.concatenate([valid_in[:, None] > 0, good > 0], axis=1)
    pb = present * (1.0 - good)                     # present-but-bad
    pbe = jnp.concatenate([rep_in.astype(jnp.float32)[:, None], pb],
                          axis=1)
    pbcum = jnp.cumsum(pbe, axis=1)                 # [C, T+1]
    sidx = jnp.broadcast_to(jnp.arange(T + 1, dtype=jnp.int32)[None],
                            (C, T + 1))
    gidx = jax.lax.cummax(jnp.where(goode, sidx, -1), axis=1)
    has = gidx >= 0
    gi = jnp.maximum(gidx, 0)
    reps = pbcum - jnp.take_along_axis(pbcum, gi, axis=1)

    w0e = jnp.concatenate([lw0[:, None], w0s], axis=1)
    Ve = jnp.concatenate([lV[:, None], Vs], axis=1)
    Ae = jnp.concatenate([lA[:, None], As], axis=1)
    use = ((good > 0) | ((present > 0) & has[:, 1:]
                         & (reps[:, 1:] <= max_repeat))
           ).astype(jnp.float32)
    t1 = gi[:, 1:]
    w0r = jnp.take_along_axis(w0e, t1, axis=1) * use
    Vr = jnp.take_along_axis(Ve, t1[:, :, None], axis=1) * use[:, :, None]
    Ar = jnp.take_along_axis(Ae, t1[:, :, None], axis=1) * use[:, :, None]

    glast = gi[:, -1:]
    lw0_o = jnp.take_along_axis(w0e, glast, axis=1)[:, 0]
    lV_o = jnp.take_along_axis(Ve, glast[:, :, None], axis=1)[:, 0]
    lA_o = jnp.take_along_axis(Ae, glast[:, :, None], axis=1)[:, 0]
    rep_o = jnp.clip(
        pbcum[:, -1] - jnp.take_along_axis(pbcum, glast, axis=1)[:, 0],
        0, max_repeat + 1).astype(jnp.int32)
    valid_o = has[:, -1].astype(jnp.float32)
    return (w0r, Vr, Ar), (lw0_o, lV_o, lA_o, rep_o, valid_o)


def ambe_tone_params(bits49):
    """AMBE+2 in-band tone fields (vocoder.glue ambe_tone_info layout):
    pitch code 0x7F with the tone ID repeated → (is_tone [F], single-
    harmonic ω0 [F], amplitude [F]).  f = 31.25·ID Hz, amp = AD·75/8000
    (OP25 soft_tonef, reference dsd_audio2.c:1290)."""
    w7 = jnp.asarray([1 << (6 - i) for i in range(7)], jnp.int32)
    b0 = bits49[:, :7].astype(jnp.int32) @ w7
    id1 = bits49[:, 7:14].astype(jnp.int32) @ w7
    ad = bits49[:, 14:21].astype(jnp.int32) @ w7
    id2 = bits49[:, 21:28].astype(jnp.int32) @ w7
    is_tone = (b0 == 0x7F) & (id1 == id2)
    w0_t = (2.0 * jnp.pi * TONE_FREQ_STEP_HZ / 8000.0
            ) * id1.astype(jnp.float32)
    amp_t = ad.astype(jnp.float32) * (TONE_AMP_STEP / 8000.0)
    return is_tone, w0_t, amp_t


def imbe_tone_params(bits88):
    """IMBE in-band tone fields (vocoder.glue layout): raw b0 code in
    [208, 219] with ID repeated at S[19:26] → (is_tone, ω0, amp)."""
    from dsdneo_tpu.vocoder.glue import IMBE_TONE_B0_MAX, IMBE_TONE_B0_MIN
    from dsdneo_tpu.vocoder.imbe import B0_HI_POS, B0_LO_POS
    hi = bits88[:, jnp.asarray(B0_HI_POS)].astype(jnp.int32)
    b0 = hi @ jnp.asarray([1 << (7 - i) for i in range(6)], jnp.int32)
    b0 = b0 | (bits88[:, B0_LO_POS[0]].astype(jnp.int32) << 1) \
            | bits88[:, B0_LO_POS[1]].astype(jnp.int32)
    w7 = jnp.asarray([1 << (6 - i) for i in range(7)], jnp.int32)
    id1 = bits88[:, 12:19].astype(jnp.int32) @ w7
    id2 = bits88[:, 19:26].astype(jnp.int32) @ w7
    ad = bits88[:, 26:33].astype(jnp.int32) @ w7
    is_tone = ((b0 >= IMBE_TONE_B0_MIN) & (b0 <= IMBE_TONE_B0_MAX)
               & (id1 == id2))
    w0_t = (2.0 * jnp.pi * TONE_FREQ_STEP_HZ / 8000.0
            ) * id1.astype(jnp.float32)
    amp_t = ad.astype(jnp.float32) * (TONE_AMP_STEP / 8000.0)
    return is_tone, w0_t, amp_t


def ambe_params_gated(bits49, errs, thr: int = 3):
    """[F, 49] AMBE bits + ECC error counts → (w0, voiced, amps, good):
    voice params for clean voice frames, single-harmonic tone params
    for clean tone frames, good=0 for over-threshold frames (which
    then route through repeat_gate).  Replaces the mute-only
    ambe_frame_mask on the batched pipelines."""
    w0, L, voiced, amps = ambe_decode_params(bits49)
    is_tone, w0_t, amp_t = ambe_tone_params(bits49)
    ok = errs <= thr
    e0 = jnp.zeros((1, MAX_L), jnp.float32).at[0, 0].set(1.0)
    w0 = jnp.where(is_tone, w0_t, w0)
    voiced = jnp.where(is_tone[:, None], e0, voiced)
    # host convention: tone pcm = amp·sin(nθ); the synth bank emits
    # 2·A·cos, so A = amp/2 lands the same amplitude
    amps = jnp.where(is_tone[:, None], e0 * (amp_t * 0.5)[:, None], amps)
    return w0, voiced, amps, ok.astype(jnp.float32)


def scatter_repeat_synth(w0, voiced, amps, good, fch, forder,
                         C: int, n_steps: int, state, pcm_fmt: str):
    """Shared tail of every batched AMBE pipeline: scatter [F]
    per-frame params onto the [C, n_steps] step grid (pad frames use
    fch == C), apply the bounded frame-repeat contract, synthesize
    with cross-block phase continuity, encode the wire format.

    ``state`` = (synth carry, repeat carry) from the previous block of
    the same channel set.  Returns (wire, new_state)."""
    from dsdneo_tpu.vocoder.synth import synthesize_stream

    def scat(vals, shape, dtype):
        z = jnp.zeros((C + 1, n_steps) + shape, dtype)
        return z.at[fch, forder].set(vals.astype(dtype))[:C]

    w0s = scat(w0, (), jnp.float32)
    Vs = scat(voiced, (MAX_L,), jnp.float32)
    As = scat(amps, (MAX_L,), jnp.float32)
    gs = scat(good, (), jnp.float32)
    ps = scat(jnp.ones_like(good), (), jnp.float32)
    synth_in, rep_in = state
    (w0r, Vr, Ar), rep_out = repeat_gate(w0s, Vs, As, gs, ps, rep_in)

    noise = (jnp.mod(jnp.arange(C * n_steps * MAX_L, dtype=jnp.float32)
                     * 2.399963, 2 * jnp.pi)).reshape(C, n_steps, MAX_L)
    pcm, t_o, w_o, a_o = jax.vmap(synthesize_stream)(
        w0r, Ar, Vr, noise, *synth_in)
    pcm = jnp.clip(pcm * 0.02, -1.0, 1.0)
    state_out = ((t_o, w_o, a_o), rep_out)
    if pcm_fmt == "adpcm":
        from dsdneo_tpu.ops.audio_wire import adpcm_compress
        return adpcm_compress(pcm.reshape(pcm.shape[0], -1)), state_out
    if pcm_fmt == "mulaw":
        y = jnp.sign(pcm) * jnp.log1p(255.0 * jnp.abs(pcm)) / np.log1p(255.0)
        return (jnp.clip((y + 1.0) * 127.5 + 0.5, 0, 255
                         ).astype(jnp.uint8), state_out)
    return pcm.astype(jnp.float16), state_out


def voice_state_init(C: int):
    """Fresh (synth carry, repeat carry) pair for scatter_repeat_synth."""
    return (synth_state_init(C), repeat_state_init(C))


def voice_state_reset(state, channels):
    """Zero the carry rows for ``channels`` in any nested per-channel
    state tuple (leading axis = channel).  A channel row retargeted to
    a new frequency mid-stream must not phase-continue the previous
    talker or repeat the previous stream's parameters — the reference
    resets its mbe state on retune (dsd_mbe.c per-slot state lives in
    the decoder context that the controller thread re-inits)."""
    ch = jnp.asarray(np.asarray(channels, np.int32))
    return jax.tree.map(lambda a: a.at[ch].set(0), state)


# -- batched AMBE+2 (2450) parameter decode ---------------------------------

@lru_cache(maxsize=1)
def _ambe_tables():
    """Per-L constant tables for the AMBE dequantizer
    (vocoder.mbe.decode_ambe_2450 vectorized): the 31 residual bits
    split across harmonics 1..L-1 (per = max(31//(L-1), 1)), each
    value mapping linearly bits→r∈[-1,1]; W[r_l] = Σ bits·w + c."""
    n_rest = 31
    W = np.zeros((N_L, n_rest, MAX_L), dtype=np.float32)
    Cc = np.zeros((N_L, MAX_L), dtype=np.float32)
    ASSIGNED = np.zeros((N_L, MAX_L), dtype=np.float32)
    for L in range(L_MIN, MAX_L + 1):
        i = L - L_MIN
        per = max(n_rest // (L - 1), 1)
        pos = 0
        for l in range(1, L):
            nbits = min(per, n_rest - pos)
            if nbits <= 0:
                break
            denom = max((1 << nbits) - 1, 1)
            for j in range(nbits):
                W[i, pos + j, l] = (1 << (nbits - 1 - j)) * 2.0 / denom
            Cc[i, l] = -1.0
            ASSIGNED[i, l] = 1.0
            pos += nbits
    return W, Cc, ASSIGNED


def ambe_decode_params(bits49):
    """[F, 49] AMBE parameter bits → (w0 [F], L [F], voiced [F, MAX_L],
    amps [F, MAX_L]) — device equivalent of
    vocoder.mbe.decode_ambe_2450 (stateless, no inter-frame
    prediction), traceable inside a jit."""
    W, Cc, ASSIGNED = (jnp.asarray(t) for t in _ambe_tables())
    S = bits49.astype(jnp.float32)
    b0 = S[:, 0:7] @ jnp.asarray([1 << (6 - i) for i in range(7)],
                                 jnp.float32)
    # mbelib-neo dequant: f0 = 2^(−4.3118 − 0.021336·(b0+0.5)) —
    # period grows with b0 (see vocoder.mbe.decode_ambe_2450)
    period = 2.0 ** (4.3118 + 0.021336 * (b0 + 0.5))
    w0 = 2.0 * jnp.pi / jnp.clip(period, 19.0, 131.0)
    L = jnp.floor(0.9254 * jnp.floor(jnp.pi / w0 + 0.25)).astype(jnp.int32)
    L = jnp.clip(L, L_MIN, MAX_L)
    li = L - L_MIN
    Lf = L.astype(jnp.float32)[:, None]

    lidx = jnp.arange(MAX_L, dtype=jnp.float32)[None, :]
    mask = (lidx < Lf).astype(jnp.float32)
    band = jnp.minimum((jnp.arange(MAX_L)[None, :] * 5) // L[:, None], 4)
    vband = S[:, 7:12]
    voiced = jnp.take_along_axis(vband, band, axis=1) * mask

    gain_idx = S[:, 12:18] @ jnp.asarray([1 << (5 - i) for i in range(6)],
                                         jnp.float32)
    gain = 10.0 ** ((gain_idx - 32.0) * 1.3 / 20.0)

    rest = S[:, 18:49]                                   # [F, 31]
    r = jnp.einsum("fb,fbl->fl", rest, W[li],
                   precision=jax.lax.Precision.HIGHEST) + Cc[li]
    amps = jnp.where(ASSIGNED[li] > 0, 10.0 ** (0.3 * r), 1.0)
    tilt = jnp.exp(-0.02 * jnp.arange(MAX_L, dtype=jnp.float32))[None, :]
    amps = amps * tilt * mask
    rms = jnp.sqrt(jnp.sum(amps ** 2, axis=1, keepdims=True)
                   / jnp.maximum(Lf, 1.0))
    amps = amps / jnp.maximum(rms, 1e-9) * gain[:, None] * 0.02
    return w0, L, voiced, amps * mask
