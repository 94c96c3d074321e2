"""Warm per-stage profile of the batched DMR voice chain (C from argv)."""
import sys, time
sys.path.insert(0, "/root/repo")
import numpy as np, jax, jax.numpy as jnp
import bench
bench.enable_compile_cache()
from dsdneo_tpu.engine.dmrbatch import (BatchedDmrVoicePipeline,
                                        synth_voice_stream,
                                        dmr_voice_decode_gather)

fs = 48000.0
samples, _dib, _bits = synth_voice_stream(n_superframes=8, seed=1)
iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
C = int(sys.argv[1]) if len(sys.argv) > 1 else 320
x = jax.device_put(np.broadcast_to(iq1[None], (C,) + iq1.shape).copy())
pipe = BatchedDmrVoicePipeline(C, fs=fs)
pipe.decode_block(x)
for rep in range(3):
    t = {}
    t0 = time.perf_counter()
    dibits_dev, idx, vq, dq, eq, n_sym = pipe.frontend_sync_device(x)
    t["frontend+blob"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ac, at, ai, fch, forder = pipe.pick_superframes(idx, vq, dq, eq, n_sym)
    t["pick(host)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    S = ac.shape[0]
    n_steps = int(forder.max()) + 1
    Sp = -(-S // 16) * 16
    Tp = -(-n_steps // 36) * 36
    acp = np.full(Sp, C, dtype=np.int32); acp[:S] = ac
    atp = np.zeros(Sp, dtype=np.int32); atp[:S] = at
    aip = np.zeros(Sp, dtype=np.int32); aip[:S] = ai
    fchp = np.full(Sp * 18, C, dtype=np.int32); fchp[:S * 18] = fch
    fordp = np.zeros(Sp * 18, dtype=np.int32); fordp[:S * 18] = forder
    t["pad"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h, _st = dmr_voice_decode_gather(
        dibits_dev, jnp.asarray(acp), jnp.asarray(atp),
        jnp.asarray(aip), pipe._offs,
        jnp.asarray(fchp), jnp.asarray(fordp), C, Tp, pcm_fmt=pipe.pcm_fmt)
    h.block_until_ready()
    t["decode(dev)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm = np.asarray(h)
    t["pcm fetch"] = time.perf_counter() - t0
    print(f"S={S} steps={n_steps}  |  " +
          "  |  ".join(f"{k}: {v*1e3:.0f}ms" for k, v in t.items()),
          flush=True)
