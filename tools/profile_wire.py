#!/usr/bin/env python3
"""Profile the PCM wire formats on the default JAX device: P25p2 + DMR + P25p1
chains at C=320, mulaw vs adpcm step time (bench.py configurations)."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (reuses enable_compile_cache + bench fns)


def time_pipe(pipe, x, reps=4):
    pcm = pipe.decode_block(x)
    bytes_out = np.asarray(pipe.decode_block_async(x)).nbytes

    def pipelined(k):
        t0 = time.perf_counter()
        prev = pipe.decode_block_async(x)
        for _ in range(k - 1):
            nxt = pipe.decode_block_async(x)
            pipe.fetch_pcm(prev)
            prev = nxt
        pipe.fetch_pcm(prev)
        return (time.perf_counter() - t0) / k

    return min(pipelined(reps) for _ in range(3)), bytes_out, pcm.shape


def main():
    bench.enable_compile_cache()
    import jax
    print("backend:", jax.default_backend(), flush=True)
    C = 320

    from dsdneo_tpu.engine.p2batch import (BatchedP2VoicePipeline,
                                           synth_p2_voice_stream)
    samples, _d, _b = synth_p2_voice_stream(n_superframes=8, seed=1)
    iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    block_s = iq1.shape[0] / 48000.0
    x = jax.device_put(iq)
    for fmt in ("mulaw", "adpcm"):
        pipe = BatchedP2VoicePipeline(C, fs=48000.0, pcm_fmt=fmt)
        dt, nbytes, shp = time_pipe(pipe, x)
        print(f"p25p2 {fmt}: step {dt*1e3:.0f} ms  x{C*block_s/dt:.0f}"
              f"  fetch {nbytes/1e6:.1f} MB  pcm {shp}", flush=True)
    from dsdneo_tpu.engine.dmrbatch import (BatchedDmrVoicePipeline,
                                            synth_voice_stream)
    s2 = synth_voice_stream(n_superframes=8, seed=1)[0]
    iq1 = np.stack([s2.real, s2.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    block_s = iq1.shape[0] / 48000.0
    x = jax.device_put(iq)
    for fmt in ("mulaw", "adpcm"):
        pipe = BatchedDmrVoicePipeline(C, fs=48000.0, pcm_fmt=fmt)
        dt, nbytes, shp = time_pipe(pipe, x)
        print(f"dmr {fmt}: step {dt*1e3:.0f} ms  x{C*block_s/dt:.0f}"
              f"  fetch {nbytes/1e6:.1f} MB  pcm {shp}", flush=True)

    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    fs, samples = bench.headline_capture()
    iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    block_s = iq1.shape[0] / fs
    x = jax.device_put(iq)
    for fmt in ("mulaw", "adpcm"):
        pipe = BatchedP25VoicePipeline(C, fs=fs, pcm_fmt=fmt)
        dt, nbytes, shp = time_pipe(pipe, x)
        print(f"p25p1 {fmt}: step {dt*1e3:.0f} ms  x{C*block_s/dt:.0f}"
              f"  fetch {nbytes/1e6:.1f} MB  pcm {shp}", flush=True)


if __name__ == "__main__":
    main()
