"""Device-side DSP front-end: pure JAX functions over batched I/Q blocks.

All functions operate on a channel-batched layout ``[C, N]`` (C channels,
N complex samples) so that one jitted step processes many channels at
once — the batched replacement for the reference's per-channel demod
thread (reference: src/dsp/demod_pipeline.cpp full_demod, the per-block
chain at :964-1330).

The chain for digital voice modes:
  cu8 widen → (fs/4 rotate) → halfband decimation cascade → channel LPF
  → FM discriminator (FSK/C4FM) | CQPSK carrier+timing chain → symbols.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def widen_cu8(raw: jax.Array) -> jax.Array:
    """uint8 interleaved I/Q ``[C, 2N]`` → complex64 ``[C, N]`` in ~[-1,1].

    Reference parity: src/dsp/simd_widen*.cpp (CU8→float widen; the fused
    fs/4 rotation is applied separately by :func:`fs4_rotate`).
    """
    x = raw.astype(jnp.float32) * (1.0 / 127.5) - 1.0
    return jax.lax.complex(x[..., 0::2], x[..., 1::2])


def fs4_rotate(x: jax.Array, sign: int = 1) -> jax.Array:
    """Multiply by exp(±j·π/2·n): shifts spectrum by fs/4 without multiplies."""
    n = x.shape[-1]
    rot = jnp.asarray([1, 1j * sign, -1, -1j * sign], dtype=jnp.complex64)
    return x * jnp.tile(rot, (n + 3) // 4)[:n]


def _fir_real(x: jax.Array, taps: jax.Array) -> jax.Array:
    """'Same'-aligned FIR of real ``[C, N]`` with 1-D taps (group delay removed)."""
    c, n = x.shape
    t = taps.shape[0]
    lhs = x[:, None, :]
    rhs = taps[::-1][None, None, :].astype(x.dtype)
    pad = ((t - 1) // 2, t - 1 - (t - 1) // 2)
    # HIGHEST: the filtered signal feeds the discriminator and the
    # slicer; a TF32 convolution would flip dibits near a threshold
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[pad],
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST)
    return out[:, 0, :]


def _fir_complex_direct(x: jax.Array, taps) -> jax.Array:
    return jax.lax.complex(_fir_real(x.real, taps), _fir_real(x.imag, taps))


def _fir_complex_fft(x: jax.Array, taps) -> jax.Array:
    """The same 'same'-aligned FIR as one FFT convolution per row:
    ``y[n] = z[n + T//2]`` of the full convolution ``z`` (the direct
    form's padding puts the odd tap of an even-length filter on the
    right)."""
    n = x.shape[-1]
    t = len(taps)
    size = 1 << (n + t - 2).bit_length()          # >= n + t - 1
    h = jnp.fft.fft(jnp.asarray(taps, jnp.complex64), size)
    z = jnp.fft.ifft(jnp.fft.fft(x, size, axis=-1) * h, axis=-1)
    return z[..., t // 2:t // 2 + n].astype(jnp.complex64)


def fir_complex(x: jax.Array, taps) -> jax.Array:
    """Complex FIR with real taps over ``[C, N]`` (same length, zero delay).

    The one place the FIR's formulation is chosen, per lowering
    platform: programs compiled for a CUDA GPU filter by FFT (cuFFT;
    the direct depthwise convolution measured 4x slower there at fleet
    widths, PERF.md), every other platform by direct convolution.  The
    two agree to float32 rounding.

    Reference parity: src/dsp/simd_fir.cpp simd_fir_complex_apply.
    """
    return jax.lax.platform_dependent(
        x, cuda=lambda v: _fir_complex_fft(v, taps),
        default=lambda v: _fir_complex_direct(v, taps))


def fir_real(x: jax.Array, taps: jax.Array) -> jax.Array:
    """Real FIR over ``[C, N]`` (same length, zero group delay)."""
    return _fir_real(x, taps)


def decimate2_halfband(x: jax.Array, taps: jax.Array) -> jax.Array:
    """Filter + decimate-by-2 of complex ``[C, N]`` → ``[C, N//2]``.

    Reference parity: src/dsp/halfband.cpp + simd_hb_decim2_complex.
    """
    y = fir_complex(x, taps)
    return y[:, ::2]


def fm_discriminate(x: jax.Array) -> jax.Array:
    """Per-sample quadrature FM discriminator over ``[C, N]``.

    out[n] = angle(x[n] · conj(x[n-1])) / π  ∈ [-1, 1]  (1.0 = Nyquist
    deviation).  First output repeats the second to keep length N.
    Reference parity: src/dsp/fsk_modem.c dsd_fsk_modem_discriminator_process
    (atan2 discriminator; DC/peak tracking is done downstream in the
    symbol-level estimator instead of here).
    """
    prev = jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)
    p = x * jnp.conj(prev)
    return jnp.arctan2(p.imag, p.real) * (1.0 / jnp.pi)


def iq_power(x: jax.Array) -> jax.Array:
    """Mean power per channel ``[C]`` (squelch/level metric)."""
    return jnp.mean(jnp.abs(x) ** 2, axis=-1)


def dc_block(x: jax.Array) -> jax.Array:
    """Remove per-channel complex DC (mean) — simple block-wise DC blocker."""
    return x - jnp.mean(x, axis=-1, keepdims=True)
