"""Wideband multi-channel decode: one wideband I/Q capture → every
active narrowband channel decoded.

The reference time-shares a single tuner across a trunked system
(src/io/radio/rtl_stream.c retune + src/engine/trunk_scan.c); the batched
build instead channelizes the whole band in one device program — the
2x-oversampled PFB (dsp.channelizer.channelize_os2) plus a halfband
decimator yields critically-clean 48 kHz basebands without the
channel-edge aliasing of a plain critically-sampled bank — and decodes
every channel that carries power.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dsdneo_tpu.dsp import firdes, frontend
from dsdneo_tpu.dsp.channelizer import (channel_frequencies, channelize,
                                        channelize_os2)
from dsdneo_tpu.engine.decoder import decode_samples
from dsdneo_tpu.protocol import base as proto_base

CHANNEL_RATE = 48000.0


@dataclass
class ChannelResult:
    index: int
    freq_hz: float                 # signed offset from band center
    power_db: float
    ctx: proto_base.DecoderContext = field(repr=False)


def channelize_band(samples: np.ndarray, fs: float, n_ch: int | None = None,
                    oversampled: bool = True
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Wideband complex ``[B]`` → (``[n_ch, B/n_ch]`` 48 kHz basebands,
    channel center offsets in Hz)."""
    if n_ch is None:
        n_ch = int(round(fs / CHANNEL_RATE))
    if n_ch < 2:
        raise ValueError(f"wideband decode needs fs >= 96 kHz (fs={fs:g})")
    if abs(fs - n_ch * CHANNEL_RATE) > 1.0:
        raise ValueError(
            f"sample rate {fs:g} is not a multiple of 48 kHz "
            f"({n_ch} channels would need {n_ch * CHANNEL_RATE:g})")
    import jax.numpy as jnp
    x = jnp.asarray(np.ascontiguousarray(samples))
    if oversampled:
        ch2 = channelize_os2(x, n_ch, taps_per_branch=12)
        hb = firdes.lowpass_taps(62, 2.0, 0.5,
                                 window="blackman-harris").astype(np.float32)
        ch = np.asarray(frontend.decimate2_halfband(ch2, hb))
    else:
        ch = np.asarray(channelize(x, n_ch, taps_per_branch=12))
    return ch.astype(np.complex64), channel_frequencies(n_ch, fs)


def decode_wideband(samples: np.ndarray, fs: float, mode="auto",
                    n_ch: int | None = None, oversampled: bool = True,
                    power_gate_db: float = -20.0, **decode_kw
                    ) -> list[ChannelResult]:
    """Channelize a wideband capture and decode every active channel.

    ``power_gate_db``: channels whose mean power is more than this far
    below the strongest channel are skipped (dead air)."""
    ch, freqs = channelize_band(samples, fs, n_ch, oversampled)
    pw = (np.abs(ch) ** 2).mean(axis=-1)
    ref = float(pw.max())
    if ref <= 0:
        return []
    gate = ref * 10.0 ** (power_gate_db / 10.0)
    out: list[ChannelResult] = []
    for k in np.argsort(freqs):
        if pw[k] < gate or pw[k] < 1e-9:
            continue
        ctx = decode_samples(ch[k], mode, fs=CHANNEL_RATE, **decode_kw)
        out.append(ChannelResult(index=int(k), freq_hz=float(freqs[k]),
                                 power_db=10.0 * np.log10(pw[k] / ref),
                                 ctx=ctx))
    return out


def channelize_band_device(samples: np.ndarray, fs: float,
                           n_ch: int | None = None):
    """channelize_band without the host round trip: returns the
    ``[n_ch, B']`` 48 kHz basebands as a DEVICE array (complex64) for
    the batched voice pipelines to consume in place."""
    if n_ch is None:
        n_ch = int(round(fs / CHANNEL_RATE))
    if abs(fs - n_ch * CHANNEL_RATE) > 1.0:
        raise ValueError(f"fs {fs:g} not a multiple of 48 kHz")
    if n_ch < 2:
        # same guard as the host channelize_band: n_ch == 1 would make
        # the os2 decimator degenerate (d = 0) and silently emit a
        # sample-doubled stream labeled 48 kHz
        raise ValueError("wideband channelizer needs fs >= 96 kHz "
                         f"(got {fs:g}); decode 48 kHz captures "
                         "directly")
    import jax
    import jax.numpy as jnp
    hb = firdes.lowpass_taps(62, 2.0, 0.5,
                             window="blackman-harris").astype(np.float32)

    @jax.jit
    def run(x):
        if x.ndim == 2:                      # [B, 2] float planes
            x = jax.lax.complex(x[..., 0], x[..., 1])
        ch2 = channelize_os2(x, n_ch, taps_per_branch=12)
        return frontend.decimate2_halfband(ch2, hb)

    # host complex ships as float planes, the pipelines' wire format
    x = np.ascontiguousarray(samples)
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        x = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return run(jnp.asarray(x)), channel_frequencies(n_ch, fs)


def decode_wideband_voice_batched(samples: np.ndarray, fs: float,
                                  n_ch: int | None = None,
                                  sync_threshold: float = 0.62):
    """BASELINE config 5 end-to-end on device: a wideband capture
    channelizes through the 2x-oversampled PFB and every channel runs
    the batched P25 voice chain (front end + sync + NID + IMBE ECC +
    dequant + synthesis) WITHOUT the basebands ever visiting the host.

    Returns (pcm [n_ch, T] float32, channel offsets Hz)."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    ch_dev, freqs = channelize_band_device(samples, fs, n_ch)
    pipe = BatchedP25VoicePipeline(int(ch_dev.shape[0]), fs=CHANNEL_RATE,
                                   sync_threshold=sync_threshold)
    return pipe.decode_block(ch_dev), freqs
