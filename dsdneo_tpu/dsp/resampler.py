"""Rational L/M polyphase resampler (upfirdn) — batched JAX.

Reference parity: src/dsp/resampler.cpp (polyphase plan held in
demod_state.h:166-183, used to pin audio output at 48 kHz when the
device forces an awkward capture rate).

Batched design: the output at rate L/M is a gather of phase-selected
FIR dot products — expressed as a dense [K, taps_per_phase] window
matrix times the filter bank, one matmul for large K.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import jax
import jax.numpy as jnp
import numpy as np

from dsdneo_tpu.dsp import firdes


@lru_cache(maxsize=32)
def _plan(l: int, m: int, taps_per_phase: int = 12):
    ntaps = l * taps_per_phase
    cutoff = 0.5 / max(l, m)
    h = firdes.lowpass_taps(ntaps - 1, 1.0, cutoff, window="blackman-harris")
    hp = np.zeros(l * taps_per_phase, dtype=np.float32)
    hp[:h.shape[0]] = h * l
    return hp.reshape(taps_per_phase, l).T.copy()   # [L phases, taps]


def resample(x: jax.Array, rate_in: int, rate_out: int,
             taps_per_phase: int = 12) -> jax.Array:
    """Resample ``[..., N]`` float/complex from rate_in to rate_out."""
    g = gcd(rate_in, rate_out)
    l, m = rate_out // g, rate_in // g
    if l == 1 and m == 1:
        return x
    bank = jnp.asarray(_plan(l, m, taps_per_phase))      # [L, P]
    P = bank.shape[1]
    n = x.shape[-1]
    k_out = (n * l) // m
    t = jnp.arange(k_out)
    # output k corresponds to input position (k·M)/L: integer part + phase
    ipos = (t * m) // l
    phase = (t * m) % l
    offs = jnp.arange(P)
    pad = P - 1
    xpad = jnp.concatenate(
        [jnp.zeros((*x.shape[:-1], pad), dtype=x.dtype), x], axis=-1)
    # y[k] = Σ_p bank[phase_k, p] · x[ipos_k − p]  (x[j] lives at xpad[j+pad])
    idx = ipos[:, None] - offs[None, :] + pad             # [K, P]
    win = xpad[..., idx]                                  # [..., K, P]
    coeffs = bank[phase]                                  # [K, P]
    if jnp.iscomplexobj(x):
        return (jnp.sum(win.real * coeffs, axis=-1)
                + 1j * jnp.sum(win.imag * coeffs, axis=-1))
    return jnp.sum(win * coeffs, axis=-1)
