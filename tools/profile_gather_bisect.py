#!/usr/bin/env python3
"""Bisect voice_decode_gather's 152 ms: time partial programs
(gather+ECC → +dequant → +scan → +synthesis → +mulaw) at C=320."""

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def main():
    bench.enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.vocoder import device as vd
    from dsdneo_tpu.vocoder import imbe

    C = 320
    fs, samples = bench.headline_capture()
    iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    pipe = BatchedP25VoicePipeline(C, fs=fs, pcm_fmt="mulaw")
    x = jax.device_put(iq)
    pipe.decode_block(x)
    h = pipe.decode_block_async(x)
    np.asarray(h)

    dibits_dev, idx, vq, dq, msg, n_sym = pipe.frontend_sync_device(x)
    ac, at, fch, forder = pipe.pick_ldus(idx, vq, dq, msg, n_sym,
                                         dibits_dev=dibits_dev)
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

    def gather_frames(dibits, ldu_ch, ldu_pos):
        Tn = dibits.shape[1]
        pos = jnp.clip(ldu_pos[:, None, None] + offs[None], 0, Tn - 1)
        ch = jnp.minimum(ldu_ch, dibits.shape[0] - 1)
        dd = dibits[ch[:, None, None], pos].reshape(-1, 72)
        f = jnp.zeros((dd.shape[0], 144), dtype=jnp.uint8)
        f = f.at[:, 0::2].set(((dd >> 1) & 1).astype(jnp.uint8))
        return f.at[:, 1::2].set((dd & 1).astype(jnp.uint8))

    from dsdneo_tpu.fec.device import imbe_ecc_batch
    from dsdneo_tpu.vocoder.synth import synthesize

    @jax.jit
    def stage_ecc(dibits, ldu_ch, ldu_pos):
        bits88, errs = imbe_ecc_batch(gather_frames(dibits, ldu_ch, ldu_pos))
        return bits88.sum() + errs.sum()

    @partial(jax.jit, static_argnames=("C", "n_steps"))
    def stage_dequant(dibits, ldu_ch, ldu_pos, fch_, ford_, C, n_steps):
        bits88, errs = imbe_ecc_batch(gather_frames(dibits, ldu_ch, ldu_pos))
        T, w0, Lv, K = vd._transforms(bits88)
        V = bits88[:, imbe.VOICING_START:imbe.VOICING_START + 12
                   ].astype(jnp.float32)
        good = vd.imbe_frame_good(bits88, errs)

        def scat(vals, shape, dtype):
            z = jnp.zeros((C + 1, n_steps) + shape, dtype)
            return z.at[fch_, ford_].set(vals.astype(dtype))[:C]
        Ts = scat(T, (vd.MAX_L,), jnp.float32)
        return Ts.sum() + scat(w0, (), jnp.float32).sum() + good.sum() \
            + scat(V, (12,), jnp.float32).sum()

    @partial(jax.jit, static_argnames=("C", "n_steps"))
    def stage_scan(dibits, ldu_ch, ldu_pos, fch_, ford_, pl, pL, C, n_steps):
        bits88, errs = imbe_ecc_batch(gather_frames(dibits, ldu_ch, ldu_pos))
        T, w0, Lv, K = vd._transforms(bits88)
        V = bits88[:, imbe.VOICING_START:imbe.VOICING_START + 12
                   ].astype(jnp.float32)
        good = vd.imbe_frame_good(bits88, errs)

        def scat(vals, shape, dtype):
            z = jnp.zeros((C + 1, n_steps) + shape, dtype)
            return z.at[fch_, ford_].set(vals.astype(dtype))[:C]
        Ts = scat(T, (vd.MAX_L,), jnp.float32)
        w0s = scat(w0, (), jnp.float32)
        Ls = scat(Lv, (), jnp.int32)
        Ks = jnp.maximum(scat(K, (), jnp.int32), 1)
        Vs = scat(V, (12,), jnp.float32)
        act = scat(good, (), jnp.float32)
        w0o, voiced, amps, f_logm, f_L = vd._prediction_scan(
            Ts, w0s, jnp.maximum(Ls, 1), Ks, Vs, act, pl, pL)
        return w0o.sum() + voiced.sum() + amps.sum()

    @partial(jax.jit, static_argnames=("C", "n_steps"))
    def stage_synth(dibits, ldu_ch, ldu_pos, fch_, ford_, pl, pL, C, n_steps):
        bits88, errs = imbe_ecc_batch(gather_frames(dibits, ldu_ch, ldu_pos))
        T, w0, Lv, K = vd._transforms(bits88)
        V = bits88[:, imbe.VOICING_START:imbe.VOICING_START + 12
                   ].astype(jnp.float32)
        good = vd.imbe_frame_good(bits88, errs)

        def scat(vals, shape, dtype):
            z = jnp.zeros((C + 1, n_steps) + shape, dtype)
            return z.at[fch_, ford_].set(vals.astype(dtype))[:C]
        Ts = scat(T, (vd.MAX_L,), jnp.float32)
        w0s = scat(w0, (), jnp.float32)
        Ls = scat(Lv, (), jnp.int32)
        Ks = jnp.maximum(scat(K, (), jnp.int32), 1)
        Vs = scat(V, (12,), jnp.float32)
        act = scat(good, (), jnp.float32)
        w0o, voiced, amps, f_logm, f_L = vd._prediction_scan(
            Ts, w0s, jnp.maximum(Ls, 1), Ks, Vs, act, pl, pL)
        noise = (jnp.mod(jnp.arange(C * n_steps * vd.MAX_L,
                                    dtype=jnp.float32)
                         * 2.399963, 2 * jnp.pi)).reshape(C, n_steps,
                                                          vd.MAX_L)
        pcm = jax.vmap(synthesize)(w0o, amps, voiced, noise)
        return pcm.sum()

    args2 = (dibits_dev, jnp.asarray(acp), jnp.asarray(atp))
    args3 = args2 + (jnp.asarray(fchp), jnp.asarray(fordp))
    args4 = args3 + (prev[0], prev[1])

    def t(fn, n=6):
        best = 1e9
        for _ in range(n):
            t0 = time.perf_counter()
            r = fn()
            np.asarray(r)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    print("ecc:", round(t(lambda: stage_ecc(*args2)), 1), "ms", flush=True)
    print("+dequant+scat:", round(t(lambda: stage_dequant(
        *args3, C=C, n_steps=Tp)), 1), "ms", flush=True)
    print("+pred scan:", round(t(lambda: stage_scan(
        *args4, C=C, n_steps=Tp)), 1), "ms", flush=True)
    print("+synth:", round(t(lambda: stage_synth(
        *args4, C=C, n_steps=Tp)), 1), "ms", flush=True)


if __name__ == "__main__":
    main()
