"""Warm per-stage profile of the batched voice chain (C from argv, default 192)."""
import sys, time
sys.path.insert(0, "/root/repo")
import numpy as np, jax, jax.numpy as jnp
import bench
bench.enable_compile_cache()
from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
from dsdneo_tpu.vocoder.device import voice_decode_device
fs, samples = bench.headline_capture()
iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
C = int(sys.argv[1]) if len(sys.argv) > 1 else 192
x = jax.device_put(np.broadcast_to(iq1[None], (C,) + iq1.shape).copy())
pipe = BatchedP25VoicePipeline(C, fs=fs)
pipe.decode_block(x)
for rep in range(3):
    t = {}
    t0 = time.perf_counter()
    dibits, bd, bs, nm = pipe.frontend_sync(x)
    t["frontend_sync"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames144, fch, forder = pipe.find_voice_frames_best(dibits, bd, bs, dibits.shape[1], nm)
    t["hunt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    F = frames144.shape[0]
    n_steps = int(forder.max()) + 1
    Fp = -(-F // 256) * 256
    Tp = -(-n_steps // 27) * 27
    f144 = np.zeros((Fp, 144), np.uint8); f144[:F] = frames144
    fchp = np.full(Fp, C, np.int32); fchp[:F] = fch
    fordp = np.zeros(Fp, np.int32); fordp[:F] = forder
    t["pad+host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm, fl, fL, _ = voice_decode_device(
        jnp.asarray(f144), jnp.asarray(fchp), jnp.asarray(fordp),
        jnp.asarray(np.zeros((C, 56), np.float32)),
        jnp.asarray(np.zeros(C, np.int32)), C, Tp)
    pcm = np.asarray(pcm)
    t["device decode+fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = pcm.astype(np.float32).reshape(C, -1)
    t["host cast"] = time.perf_counter() - t0
    print("  |  ".join(f"{k}: {v*1e3:.0f}ms" for k, v in t.items()), flush=True)
