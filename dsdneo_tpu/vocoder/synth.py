"""Batched MBE harmonic synthesis — the voice device kernel.

Given per-frame (ω0, amplitudes[L], voiced[L]) parameter arrays, emits
160 samples of 8 kHz PCM per frame:

  voiced bands:   Σ_l 2·A_l·cos(l·θ(n) + φ_l)   with the fundamental
                  phase θ carried across frames (lax.scan carry) and
                  ω0/A interpolated across each frame;
  unvoiced bands: banded filtered noise on a fixed 50 Hz DFT grid —
                  every 8000/160 Hz bin inside an unvoiced band gets a
                  per-frame random phase and the band's amplitude
                  (scaled so band power matches ideal filtered noise);
                  frame-rate phase re-randomization broadens each bin
                  into a 50 Hz sinc² lobe and adjacent lobes tile the
                  band (Σ sinc² = 1), so the in-band spectrum is flat
                  like true filtered noise (mbelib's unvoiced
                  synthesis contract, src/core/vocoder/dsd_mbe.c:199),
                  not a tonal line spectrum.

The voiced product  cos(outer(n, l)) @ A  is a [160, L] × [L]
contraction; the unvoiced product is a [F, K] × [K, 160] matmul
against a CONSTANT bin basis.  Replaces the external mbelib-neo
synthesis (reference call contract src/core/vocoder/dsd_mbe.c).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

N = 160          # samples per 20 ms frame at 8 kHz
MAX_L = 56
N_BINS = 79      # unvoiced noise grid: 50·(k+1) Hz, k < 79 (50..3950)

# constant unvoiced bin bases cos/sin(ω_k n), ω_k = 2π(k+1)/N — each
# bin is exactly periodic over the frame, so the per-frame synthesis
# is one [F, K] @ [K, N] matmul per table
_BIN_W = 2.0 * np.pi * (np.arange(N_BINS) + 1.0) / N         # [K]
_BIN_COS = np.cos(np.outer(_BIN_W, np.arange(N))).astype(np.float32)
_BIN_SIN = np.sin(np.outer(_BIN_W, np.arange(N))).astype(np.float32)


def synthesize_stream(w0: jax.Array, amps: jax.Array, voiced: jax.Array,
                      noise_phase: jax.Array, theta_in: jax.Array,
                      w_in: jax.Array, a_in: jax.Array):
    """Streaming form: ``(theta_in, w_in, a_in)`` is the carry from the
    previous block of the same voice stream (fundamental phase at the
    block seam, last frame's ω0 and amplitudes), so consecutive blocks
    concatenate without a phase/amplitude discontinuity.  ``w_in <= 0``
    means "no previous frame" (fresh stream / silence before): the
    first frame then anchors interpolation to itself, which reproduces
    the one-shot behavior exactly.  Returns (pcm [F, N], theta_out,
    w_out, a_out)."""
    F = w0.shape[0]
    n_idx = jnp.arange(N, dtype=jnp.float32)                    # [N]

    fresh = w_in <= 0.0
    w_prev0 = jnp.where(fresh, w0[0], w_in)
    a_prev0 = jnp.where(fresh, amps[0], a_in)
    w_prev = jnp.concatenate([w_prev0[None], w0[:-1]])
    a_prev = jnp.concatenate([a_prev0[None, :], amps[:-1]], axis=0)

    # per-frame fundamental-phase increment with linear ω interpolation:
    # θ(n) = θ0 + Σ_{m<=n} ω(m),  ω(m) = ω_prev + (ω-ω_prev)(m+1)/N
    alpha = (n_idx + 1.0) / N                                   # [N]
    # closed form of the in-frame sum (no cumsum, whose summation order
    # XLA picks per backend): Σ_{m<=n} ω(m) = (n+1)·ω_prev
    #   + (ω-ω_prev)·(n+1)(n+2)/(2N)
    ramp = (n_idx + 1.0) * (n_idx + 2.0) / (2.0 * N)            # [N]
    cum = ((n_idx + 1.0)[None, :] * w_prev[:, None]
           + (w0 - w_prev)[:, None] * ramp[None, :])            # [F,N]
    # the frame-level sum wraps mod 2π at every step of a fixed scan
    # tree, so the phase never grows to where a float32 ulp moves
    # harmonic l by l·ulp(θ), and every backend adds in the same order
    two_pi = jnp.float32(2 * np.pi)
    frame_adv = jnp.mod(cum[:, -1], two_pi)                     # [F]
    ends = jax.lax.associative_scan(
        lambda x, y: jnp.mod(x + y, two_pi),
        jnp.concatenate([jnp.mod(theta_in, two_pi)[None], frame_adv]))
    theta0 = ends[:-1]                                          # [F]
    theta = theta0[:, None] + cum                               # [F,N]
    theta_out = ends[-1]

    v = voiced > 0.5                                            # [F,L]
    P = jnp.where(v, 1.0, 0.0)       # voiced bands only; unvoiced
    # bands synthesize through the banded-noise grid below

    # Harmonic phasors z^l = e^{ilθ} built by log-doubling from the
    # single transcendental pair (cosθ, sinθ): new_powers = powers ·
    # z^k doubles the bank per step, so the full [F, N, L] cos/sin
    # tables cost 6 complex-multiply passes instead of 2·F·N·L
    # transcendental evaluations.
    pr = jnp.cos(theta)[:, :, None]                             # [F,N,1]
    pi = jnp.sin(theta)[:, :, None]
    while pr.shape[-1] < MAX_L:
        zkr = pr[:, :, -1:]                                     # z^k
        zki = pi[:, :, -1:]
        pr, pi = (jnp.concatenate([pr, pr * zkr - pi * zki], axis=-1),
                  jnp.concatenate([pi, pr * zki + pi * zkr], axis=-1))
    pr = pr[:, :, :MAX_L]                                       # cos(lθ)
    pi = pi[:, :, :MAX_L]                                       # sin(lθ)

    # wave_l = P_l·cos(lθ) (voiced bands), and the amplitude
    # interpolation a_t = a_prev·(1−α) + a·α is separable in n, so the
    # harmonic sum reduces to two contractions in one einsum:
    cc = jnp.stack([amps * P, a_prev * P], axis=-1)             # [F,L,2]
    S = jnp.einsum("fnl,flk->fnk", pr, cc,
                   precision=jax.lax.Precision.HIGHEST)         # [F,N,2]
    pcm = 2.0 * (alpha[None, :] * S[:, :, 0]
                 + (1.0 - alpha)[None, :] * S[:, :, 1])         # [F,N]

    # unvoiced bands: banded filtered noise on the fixed 50 Hz grid.
    # Bin k (ω_k) belongs to harmonic band l = ⌊ω_k/ω0 + ½⌋; its
    # amplitude is the band's A_l scaled by √(ω_bin/ω0) so the band's
    # total power matches the voiced convention (2·A_l² for a band of
    # ω0/ω_bin bins); per-frame random phases come from the caller's
    # noise_phase table (expanded across the grid).  Frame-local (no
    # carry): block-split invariance is preserved by construction.
    L = amps.shape[1]
    w0_safe = jnp.maximum(w0, 1e-3)[:, None]                    # [F,1]
    wbin = jnp.float32(2.0 * np.pi / N)
    l_raw = jnp.floor(jnp.asarray(_BIN_W)[None, :] / w0_safe
                      + 0.5).astype(jnp.int32)                  # [F,K]
    in_band = (l_raw >= 1) & (l_raw <= L)
    li = jnp.clip(l_raw, 1, L) - 1
    a_k = jnp.take_along_axis(amps, li, axis=1)                 # [F,K]
    uv_k = 1.0 - jnp.take_along_axis(v.astype(jnp.float32), li,
                                     axis=1)
    c_k = (2.0 * a_k * jnp.sqrt(wbin / w0_safe)
           * uv_k * in_band.astype(jnp.float32))                # [F,K]
    kk = np.arange(N_BINS)
    phi = (noise_phase[:, jnp.asarray(kk % noise_phase.shape[1])]
           + jnp.asarray((2.399963 * (kk // noise_phase.shape[1])
                          * (kk + 3)).astype(np.float32)))      # [F,K]
    # cos(ω_k n − φ_k) = cosφ·cos(ω_k n) + sinφ·sin(ω_k n)
    pcm = pcm + (jnp.matmul(c_k * jnp.cos(phi), jnp.asarray(_BIN_COS),
                            precision=jax.lax.Precision.HIGHEST)
                 + jnp.matmul(c_k * jnp.sin(phi), jnp.asarray(_BIN_SIN),
                              precision=jax.lax.Precision.HIGHEST))
    return pcm, theta_out, w0[-1], amps[-1]


@partial(jax.jit, static_argnames=())
def synthesize(w0: jax.Array, amps: jax.Array, voiced: jax.Array,
               noise_phase: jax.Array) -> jax.Array:
    """[F] ω0, [F, L] amps, [F, L] voiced, [F, L] random phases →
    [F, N] float PCM (one-shot: the whole stream in one call)."""
    pcm, _t, _w, _a = synthesize_stream(
        w0, amps, voiced, noise_phase, jnp.float32(0.0),
        jnp.float32(0.0), jnp.zeros_like(amps[0]))
    return pcm


def synthesize_frames(frames) -> np.ndarray:
    """Host helper: list[MbeFrame] → concatenated float PCM [F·160]."""
    from dsdneo_tpu.vocoder.mbe import frames_to_arrays
    if not frames:
        return np.zeros(0, dtype=np.float32)
    w0, amps, voiced = frames_to_arrays(frames)
    rng = np.random.default_rng(1234)
    noise = rng.uniform(0, 2 * np.pi,
                        size=voiced.shape).astype(np.float32)
    pcm = synthesize(jnp.asarray(w0), jnp.asarray(amps),
                     jnp.asarray(voiced), jnp.asarray(noise))
    out = np.asarray(pcm).reshape(-1)
    peak = np.abs(out).max()
    if peak > 0.5:
        out = out * (0.5 / peak)
    return out
