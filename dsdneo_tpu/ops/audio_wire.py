"""PCM wire formats for the device→host audio fetch.

The device step can compress the synthesized 8 kHz PCM before the
device-to-host fetch (whether that pays on a given link is for the
bench to judge):

  - "f16"   — 2 B/sample (baseline)
  - "mulaw" — G.711 µ-law, 1 B/sample, ~38 dB SNDR (telephony standard)
  - "adpcm" — IMA/DVI-4 ADPCM, 0.5 B/sample, ~30 dB SNDR for speech —
    halves the transfer again vs µ-law.  Encode is a `lax.scan` over the
    sample axis (the predictor recurrence is inherently sequential;
    the C≥256 stream axis is the parallel dimension, so the scan body
    runs wide), decode is a native C++ kernel (native/audio_codec.cpp)
    because a 30M-sample Python loop would cost more than the halved
    transfer saves.

Each fetched block is a self-contained IMA stream starting from the
standard (predictor=0, index=0) state — blocks are seconds long, so the
few-ms adaptation transient is inaudible and no per-block header is
needed.  Reference counterpart: the reference plays 16-bit PCM straight
to the audio backend (src/core/audio/dsd_audio.c:798); the wire format
exists because the rebuild's synthesis runs on a device, across a
host link.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# standard IMA ADPCM tables
STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428,
    4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086,
    29794, 32767], dtype=np.int32)
INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                        -1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)


def adpcm_compress(pcm: jnp.ndarray) -> jnp.ndarray:
    """Device IMA ADPCM encode: [S, T] float in [-1, 1] → [S, T//2]
    uint8 (two 4-bit codes per byte, even sample in the low nibble).
    T must be even (synthesis frames are 160 samples)."""
    S, T = pcm.shape
    x = jnp.round(pcm * 32767.0).astype(jnp.int32)          # [S, T]
    steps = jnp.asarray(STEP_TABLE)
    itab = jnp.asarray(INDEX_TABLE)

    def body(carry, xt):
        pred, idx = carry
        step = steps[idx]
        diff = xt - pred
        sign = (diff < 0).astype(jnp.int32)
        ad = jnp.abs(diff)
        b2 = (ad >= step).astype(jnp.int32)
        ad = ad - b2 * step
        h1 = step >> 1
        b1 = (ad >= h1).astype(jnp.int32)
        ad = ad - b1 * h1
        h2 = step >> 2
        b0 = (ad >= h2).astype(jnp.int32)
        vpdiff = (step >> 3) + b2 * step + b1 * h1 + b0 * h2
        pred = jnp.clip(pred + jnp.where(sign == 1, -vpdiff, vpdiff),
                        -32768, 32767)
        code = (sign << 3) | (b2 << 2) | (b1 << 1) | b0
        idx = jnp.clip(idx + itab[code], 0, 88)
        return (pred, idx), code.astype(jnp.uint8)

    init = (jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.int32))
    _, codes = jax.lax.scan(body, init, x.T, unroll=8)      # [T, S]
    codes = codes.T                                         # [S, T]
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(jnp.uint8)


def adpcm_expand_np(blob: np.ndarray) -> np.ndarray:
    """Pure-NumPy reference decoder (slow; tests + fallback): [S, T2]
    uint8 → [S, 2·T2] float32."""
    S, T2 = blob.shape
    codes = np.zeros((S, 2 * T2), dtype=np.int32)
    codes[:, 0::2] = blob & 0xF
    codes[:, 1::2] = blob >> 4
    pred = np.zeros(S, np.int32)
    idx = np.zeros(S, np.int32)
    out = np.empty((S, 2 * T2), dtype=np.float32)
    for t in range(2 * T2):
        c = codes[:, t]
        step = STEP_TABLE[idx]
        vpdiff = ((step >> 3) + np.where(c & 4, step, 0)
                  + np.where(c & 2, step >> 1, 0)
                  + np.where(c & 1, step >> 2, 0))
        pred = np.clip(pred + np.where(c & 8, -vpdiff, vpdiff),
                       -32768, 32767)
        idx = np.clip(idx + INDEX_TABLE[c], 0, 88)
        out[:, t] = pred
    return out / 32767.0


def adpcm_expand(blob: np.ndarray) -> np.ndarray:
    """Host ADPCM decode, native C++ when available."""
    from dsdneo_tpu.runtime import native
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    out = native.adpcm_decode(blob)
    if out is not None:
        return out
    return adpcm_expand_np(blob)


def wire_expand(a: np.ndarray, pcm_fmt: str, n_streams: int) -> np.ndarray:
    """Shared fetch-side expansion for a pipeline's PCM handle."""
    if pcm_fmt == "adpcm":
        return adpcm_expand(a.reshape(n_streams, -1))
    if a.dtype == np.uint8:                       # mulaw
        from dsdneo_tpu.engine.dmrbatch import mulaw_expand
        return mulaw_expand(a).reshape(n_streams, -1)
    return a.astype(np.float32).reshape(n_streams, -1)
