"""CQPSK/LSM (π/4-DQPSK) demodulation — feed-forward batched design.

The reference's chain is a cascade of per-sample feedback loops
(src/dsp/costas.cpp: AGC → FLL band-edge → Gardner TED → differential
phasor → Costas, documented include/dsd-neo/dsp/costas.h:9-20).  Those
loops serialize on the sample axis, so this module replaces them with
feed-forward equivalents of the same estimators:

  1. carrier: the 4th-power spectral line (QPSK modulation-stripping)
     gives the CFO in one FFT — the FLL's steady state;
  2. matched filter: RRC (the Gardner loop's input filter);
  3. timing: Oerder&Meyr square-law phase — the TED's steady state —
     with per-window drift tracking;
  4. differential phasor: s_k·conj(s_{k-1}) and its angle IS the π/4
     DQPSK symbol (±45° = ±1, ±135° = ±3), absorbing residual carrier
     phase exactly as the reference's diff-phasor + Costas pair does.

Output soft symbols use the same ±1/±3 alphabet as the C4FM
discriminator path, so the slicer/framesync/protocol stack is shared.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.dsp import firdes, frontend


def estimate_cfo_qpsk(x: jax.Array, fs: float, symbol_rate: float,
                      pull_in_hz: float = 0.0) -> jax.Array:
    """Carrier offset per channel via the 4th-power method: ``[C]`` Hz.

    π/4-DQPSK phase increments are odd multiples of π/4, so x⁴ carries a
    deterministic π flip per symbol: its spectral line sits at
    4·CFO + symbol_rate/2, not 4·CFO.

    ``pull_in_hz`` bounds the CFO search range — the feed-forward
    analogue of the Costas loop bandwidth's pull-in limit
    (DSD_NEO_COSTAS_BW); 0 searches the full spectrum."""
    x4 = x ** 4
    n = x.shape[-1]
    spec = jnp.abs(jnp.fft.fft(x4, axis=-1))
    freqs = jnp.fft.fftfreq(n, 1.0 / fs)
    # the line lives at 4·CFO + Rs/2: a ±pull_in CFO range maps to
    # Rs/2 ± 4·pull_in in the x⁴ spectrum.  The window is ALWAYS
    # applied: the π-flip alternation also raises a mirror line at
    # 4·CFO − Rs/2, and an unmasked argmax can lock onto it (returning
    # CFO − Rs/4 and de-rotating the block out of the RRC passband) —
    # the default ±Rs/8 pull-in keeps the mirror a full Rs away
    pi_hz = pull_in_hz if pull_in_hz > 0 else symbol_rate / 8.0
    mask = jnp.abs(freqs - symbol_rate / 2.0) <= 4.0 * pi_hz
    spec = jnp.where(mask[None, :], spec, 0.0)
    k = jnp.argmax(spec, axis=-1)
    return (freqs[k] - symbol_rate / 2.0) / 4.0


def estimate_cfo_qpsk_windowed(x: jax.Array, fs: float,
                               symbol_rate: float, n_windows: int,
                               pull_in_hz: float = 0.0) -> jax.Array:
    """Per-window 4th-power CFO estimates: ``[C, W]`` Hz at the centers
    of ``n_windows`` equal slices of the block.

    The single-FFT estimator assumes the carrier is constant across the
    block; a drifting oscillator smears the x⁴ line by 4·slope·T Hz and
    the argmax fails beyond ~150 Hz/s on 2 s blocks (measured).  Short
    windows keep the smear inside one bin — the feed-forward analogue of
    the reference FLL's continuous tracking (src/dsp/costas.cpp:1176)."""
    c, n = x.shape
    w = n // n_windows
    xw = x[:, :w * n_windows].reshape(c * n_windows, w)
    cfo = estimate_cfo_qpsk(xw, fs, symbol_rate, pull_in_hz=pull_in_hz)
    return cfo.reshape(c, n_windows)


def demod_cqpsk(x: jax.Array, fs: float, symbol_rate: float,
                rrc_alpha: float = 0.2, n_sym: int | None = None,
                ted_gain: float = 1.0, pull_in_hz: float = 0.0,
                cfo_prior: float | None = None, cfo_alpha: float = 1.0,
                cfo_windows: int = 1):
    """``[C, N]`` complex baseband → (soft symbols ``[C, K]`` in the
    ±1/±3 alphabet, cfo estimates ``[C]``).

    ``ted_gain`` (DSD_NEO_TED_GAIN) scales the timing tracking
    bandwidth: the reference's Gardner loop gain sets how fast timing
    follows drift; here the equivalent lever is the O&M window length
    (higher gain → shorter windows → faster tracking).  ``cfo_prior`` +
    ``cfo_alpha`` blend the block estimate with cross-block carrier
    state (DSD_NEO_COSTAS_DAMPING: heavier damping → slower carrier
    response).  ``cfo_windows`` > 1 estimates the carrier per window and
    de-rotates with the piecewise-linear interpolated trajectory —
    tracks a drifting oscillator within the block the way the
    reference's FLL does continuously (src/dsp/costas.cpp:1176)."""
    c, n = x.shape
    sps = fs / symbol_rate
    if n_sym is None:
        n_sym = int((n - 2 * sps) // sps) - 1

    # 1. CFO correction
    if cfo_windows > 1:
        cfo_w = estimate_cfo_qpsk_windowed(x, fs, symbol_rate,
                                           cfo_windows,
                                           pull_in_hz=pull_in_hz)
        if cfo_prior is not None and cfo_alpha < 1.0:
            cfo_w = cfo_alpha * cfo_w + (1.0 - cfo_alpha) * cfo_prior
        w = n // cfo_windows
        centers = ((jnp.arange(cfo_windows, dtype=jnp.float32) + 0.5)
                   * w)
        tidx = jnp.arange(n, dtype=jnp.float32)
        cfo_t = jax.vmap(lambda cw: jnp.interp(tidx, centers, cw))(cfo_w)
        # integrated phase keeps the de-rotation continuous at window
        # seams (the differential phasor only forgives CONSTANT phase)
        phase = (2.0 * jnp.pi / fs) * jnp.cumsum(cfo_t, axis=-1)
        x = x * jnp.exp(-1j * phase)
        cfo = cfo_w.mean(axis=-1)
    else:
        cfo = estimate_cfo_qpsk(x, fs, symbol_rate, pull_in_hz=pull_in_hz)
        if cfo_prior is not None and cfo_alpha < 1.0:
            cfo = cfo_alpha * cfo + (1.0 - cfo_alpha) * cfo_prior
        t = jnp.arange(n, dtype=jnp.float32) / fs
        x = x * jnp.exp(-2j * jnp.pi * cfo[:, None] * t[None, :])

    # 2. RRC matched filter
    taps = jnp.asarray(firdes.rrc(sps, int(8 * sps) | 1, rrc_alpha))
    y = frontend.fir_complex(x, taps)

    # 3. timing from the squared envelope (windowed O&M w/ drift unwrap)
    from dsdneo_tpu.symbols.timing import decision_positions
    e = jnp.abs(y) ** 2
    win = 128
    if ted_gain != 1.0:
        win = int(np.clip(round(128.0 / max(ted_gain, 1e-3)), 32, 512))
    pos = decision_positions(e, sps, win_symbols=win, max_symbols=n_sym + 1)
    i0 = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - i0.astype(jnp.float32))[..., None]
    yr = jnp.stack([y.real, y.imag], axis=-1)
    g0 = jnp.take_along_axis(yr, i0[..., None].repeat(2, axis=-1), axis=1)
    g1 = jnp.take_along_axis(yr, (i0 + 1)[..., None].repeat(2, axis=-1), axis=1)
    sym2 = g0 * (1 - frac) + g1 * frac
    s = jax.lax.complex(sym2[..., 0], sym2[..., 1])      # [C, K+1]

    # 4. differential phasor → π/4-DQPSK soft symbols
    d = s[:, 1:] * jnp.conj(s[:, :-1])
    ang = jnp.arctan2(d.imag, d.real)                    # ±π/4, ±3π/4
    soft = ang * (4.0 / jnp.pi)                          # → ±1, ±3
    return soft, cfo


@partial(jax.jit, static_argnames=("fs", "symbol_rate", "n_sym"))
def demod_cqpsk_jit(x, fs: float, symbol_rate: float, n_sym: int):
    return demod_cqpsk(x, fs, symbol_rate, n_sym=n_sym)
