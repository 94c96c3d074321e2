#!/usr/bin/env python3
"""Stage profile of the P25p1 batched chain at C=320 on the default
JAX device."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def main():
    bench.enable_compile_cache()
    import jax
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.vocoder.device import voice_decode_gather

    C = 320
    fs, samples = bench.headline_capture()
    iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    pipe = BatchedP25VoicePipeline(C, fs=fs, pcm_fmt="mulaw")
    x = jax.device_put(iq)
    pipe.decode_block(x)                       # warm
    print("backend:", jax.default_backend(), flush=True)

    def t(fn, n=6):
        best = 1e9
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    # stage 1: front end + sync + NID device program, ends in blob fetch
    r1 = t(lambda: pipe.frontend_sync_device(x))
    print(f"frontend_sync_device (incl blob fetch): {r1:.1f} ms", flush=True)

    dibits_dev, idx, vq, dq, msg, n_sym = pipe.frontend_sync_device(x)
    # stage 2: host pick
    r2 = t(lambda: pipe.pick_ldus(idx, vq, dq, msg, n_sym,
                                  dibits_dev=dibits_dev))
    print(f"pick_ldus (host): {r2:.1f} ms", flush=True)

    # stage 3: full async dispatch minus stage1+2 work, measured via
    # complete decode_block_async + device sync on the result
    def full():
        h = pipe.decode_block_async(x)
        np.asarray(h)                       # fetch = sync
    r3 = t(full)
    print(f"decode_block_async + fetch: {r3:.1f} ms", flush=True)

    # stage 3b: dispatch only (async): shows host-side critical path
    r4 = t(lambda: pipe.decode_block_async(x))
    print(f"decode_block_async dispatch only: {r4:.1f} ms", flush=True)

    # stage 4: PCM fetch alone on a fresh handle
    h = pipe.decode_block_async(x)
    np.asarray(h)
    r5 = t(lambda: pipe.fetch_pcm(h))
    print(f"fetch_pcm (cached device array): {r5:.1f} ms", flush=True)


if __name__ == "__main__" and "--gather" not in sys.argv:
    main()


def gather_only():
    bench.enable_compile_cache()
    import jax
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline

    C = 320
    fs, samples = bench.headline_capture()
    iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    pipe = BatchedP25VoicePipeline(C, fs=fs, pcm_fmt="mulaw")
    x = jax.device_put(iq)
    pipe.decode_block(x)
    h = pipe.decode_block_async(x)
    np.asarray(h)                                  # drain queue

    # rebuild the gather inputs exactly as decode_block_async does
    from dsdneo_tpu.vocoder.device import voice_decode_gather
    dibits_dev, idx, vq, dq, msg, n_sym = pipe.frontend_sync_device(x)
    ac, at, fch, forder = pipe.pick_ldus(idx, vq, dq, msg, n_sym,
                                         dibits_dev=dibits_dev)
    import inspect
    src = inspect.getsource(pipe.decode_block_async)
    L = ac.shape[0]
    n_steps = int(forder.max()) + 1
    Lp = -(-L // 32) * 32
    Tp = -(-n_steps // 27) * 27
    acp = np.full(Lp, pipe.C, dtype=np.int32); acp[:L] = ac
    atp = np.zeros(Lp, dtype=np.int32); atp[:L] = at
    fchp = np.full(Lp * 9, pipe.C, dtype=np.int32); fchp[:L * 9] = fch
    fordp = np.zeros(Lp * 9, dtype=np.int32); fordp[:L * 9] = forder
    offs = pipe._frame_offs
    prev = pipe._dev_pred_state
    import jax.numpy as jnp
    def run():
        out = voice_decode_gather(dibits_dev, jnp.asarray(acp),
                                  jnp.asarray(atp), jnp.asarray(offs),
                                  jnp.asarray(fchp), jnp.asarray(fordp),
                                  prev[0], prev[1], pipe.C, Tp,
                                  pcm_fmt=pipe.pcm_fmt)
        np.asarray(out[0][0, 0])       # scalar fetch = device sync
    best = 1e9
    for _ in range(6):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    print(f"voice_decode_gather alone: {best*1e3:.1f} ms", flush=True)


if __name__ == "__main__" and "--gather" in sys.argv:
    gather_only()
