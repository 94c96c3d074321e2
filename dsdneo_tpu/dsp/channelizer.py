"""Polyphase filter-bank channelizer: wideband I/Q → N channel basebands.

The headline many-channel mode (BASELINE.json config 5): one wideband
capture (e.g. 3.2 MHz ≈ 256 × 12.5 kHz) splits into N critically-sampled
channels in a single device program —

    polyphase decompose [B] → [B/N, N] → per-branch FIR (a depthwise
    conv) → IFFT across the branch axis → [N, B/N]
    complex basebands,

which then feed the batched demod step (engine.batched.frontend_step).
The reference instead time-shares ONE tuner over channels
(src/engine/trunk_scan.c); the channelizer is where the batched build
fundamentally outruns it.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.dsp import firdes


@lru_cache(maxsize=8)
def prototype_taps(n_ch: int, taps_per_branch: int = 8,
                   cutoff: float = 0.5) -> np.ndarray:
    """Prototype lowpass for an N-channel PFB.  ``cutoff`` is in units
    of the channel spacing: 0.5 (half the spacing) for critical
    sampling; a 2x-oversampled bank may widen it (the bin rate
    faithfully carries ±1.0 spacing), which keeps signals sitting
    between bin centers inside the passband."""
    ntaps = n_ch * taps_per_branch
    h = firdes.lowpass_taps(ntaps - 1, float(n_ch), cutoff,
                            window="blackman-harris")
    out = np.zeros(ntaps, dtype=np.float32)
    out[:h.shape[0]] = h
    return out * n_ch


def channelize(x: jax.Array, n_ch: int, taps_per_branch: int = 8,
               cutoff: float = 0.5) -> jax.Array:
    """``[B]`` (or ``[..., B]``) wideband complex → ``[..., n_ch, B/n_ch]``.

    Critically sampled DFT filter bank; channel k is centered at
    k·fs/n_ch (wrapping to negative frequencies past n_ch/2).
    """
    h = prototype_taps(n_ch, taps_per_branch, cutoff)
    P = taps_per_branch
    b = x.shape[-1]
    m = b // n_ch
    xp = x[..., : m * n_ch].reshape(*x.shape[:-1], m, n_ch)
    # polyphase branches: branch i uses taps h[i::n_ch] over the block axis
    hp = jnp.asarray(h.reshape(P, n_ch))               # [P, n_ch]
    # FIR along the m axis per branch: y[t, i] = Σ_p h[p, i] · xp[t-p, i]
    pad = jnp.zeros((*xp.shape[:-2], P - 1, n_ch), dtype=xp.dtype)
    xpad = jnp.concatenate([pad, xp], axis=-2)         # [m+P-1, n_ch]
    y = jnp.zeros_like(xp)
    for p in range(P):
        # static slice (p, m are trace-time ints), not a jnp.arange
        # gather: XLA fuses slices into the multiply-add
        y = y + xpad[..., P - 1 - p:P - 1 - p + m, :] * hp[p][None, :]
    # DFT across branches → channels (forward FFT aligns channel k with
    # center +k·fs/N for the x[mN+i] branch convention)
    ch = jnp.fft.fft(y, axis=-1)                       # [m, n_ch]
    return jnp.moveaxis(ch, -1, -2).astype(jnp.complex64)  # [n_ch, m]


def channelize_os2(x: jax.Array, n_ch: int, taps_per_branch: int = 12,
                   cutoff: float = 0.5) -> jax.Array:
    """2x-oversampled PFB: ``[B]`` wideband → ``[n_ch, 2B/n_ch]``.

    Critical sampling aliases the channel edges back in-band; running
    the bank twice with a half-stride offset (phase-corrected by
    (-1)^k per bin, since an N/2 time shift is e^{-jπk} per channel)
    and interleaving yields each channel at twice the spacing rate —
    edge energy then sits above the eventual ±fs/2N band and a clean
    decimation (dsp.frontend.decimate2_halfband) removes it.
    """
    d = n_ch // 2
    b = x.shape[-1]
    m = (b - d) // n_ch
    n = m * n_ch
    s0 = channelize(x[..., :n], n_ch, taps_per_branch, cutoff)
    s1 = channelize(x[..., d:d + n], n_ch, taps_per_branch, cutoff)
    k = jnp.arange(n_ch)
    phase = jnp.where(k % 2 == 0, 1.0, -1.0).astype(jnp.complex64)
    s1 = s1 * phase[:, None]
    out = jnp.stack([s0, s1], axis=-1).reshape(*s0.shape[:-1], 2 * m)
    return out.astype(jnp.complex64)


def channel_frequencies(n_ch: int, fs: float) -> np.ndarray:
    """Center frequency of each channelizer output (Hz, signed)."""
    k = np.arange(n_ch)
    k = np.where(k <= n_ch // 2, k, k - n_ch)
    return k * (fs / n_ch)
