"""Warm per-stage profile of the batched P25p2 voice chain."""
import sys, time
sys.path.insert(0, "/root/repo")
import numpy as np, jax, jax.numpy as jnp
import bench
bench.enable_compile_cache()
from dsdneo_tpu.engine.p2batch import (BatchedP2VoicePipeline,
                                       synth_p2_voice_stream)

fs = 48000.0
samples, _dib, _bits = synth_p2_voice_stream(n_superframes=8, seed=1)
iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
C = int(sys.argv[1]) if len(sys.argv) > 1 else 320
x = jax.device_put(np.broadcast_to(iq1[None], (C,) + iq1.shape).copy())
pipe = BatchedP2VoicePipeline(C, fs=fs, pcm_fmt="mulaw")
pipe.decode_block(x)
for rep in range(3):
    t = {}
    t0 = time.perf_counter()
    dibits_dev, idx, vq, duid, isch, n_sym = pipe.frontend_sync_device(x)
    t["frontend+blob"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrs, ess_jobs = pipe.walk_frames(idx, vq, duid, isch, n_sym)
    t["walk(host)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = pipe.decode_block_async(x)
    t["full redo(dispatch)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm = np.asarray(h)
    t["pcm fetch"] = time.perf_counter() - t0
    print(f"F={arrs[0].shape[0]}  |  " +
          "  |  ".join(f"{k}: {v*1e3:.0f}ms" for k, v in t.items()),
          flush=True)
