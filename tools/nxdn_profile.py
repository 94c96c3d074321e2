"""Warm per-stage profile of the batched NXDN48 voice chain
(C from argv, default 320) — VERDICT r3 weak #1: nxdn48_step_ms 1272
vs DMR 642 at the same C."""
import sys
import time

sys.path.insert(0, "/root/repo")
import numpy as np
import jax
import jax.numpy as jnp

import bench

bench.enable_compile_cache()
from dsdneo_tpu.engine.nxdnbatch import BatchedNxdnVoicePipeline
from dsdneo_tpu.io import read_iq_capture

meta, samples = read_iq_capture(
    "/root/reference/tests/fixtures/iq/nxdn48.iq.json")
fs = float(meta.sample_rate_hz)
iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
C = int(sys.argv[1]) if len(sys.argv) > 1 else 320
x = jax.device_put(np.broadcast_to(iq1[None], (C,) + iq1.shape).copy())
pipe = BatchedNxdnVoicePipeline(C, fs=fs, pcm_fmt="adpcm")
print("block_s", iq1.shape[0] / fs, "C", C)
pipe.decode_block(x)            # compile
for rep in range(3):
    t = {}
    t0 = time.perf_counter()
    fe = pipe.frontend_dispatch(x)
    t["frontend dispatch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe6 = pipe.frontend_finish(fe)
    t["frontend finish (blob fetch)"] = time.perf_counter() - t0
    dibits_dev, idx, vq, dq, lich, n_sym = fe6
    t0 = time.perf_counter()
    ac, at, ai, fch, forder = pipe.pick_frames(idx, vq, dq, lich, n_sym)
    t["host pick"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = pipe.decode_from_frontend(fe6)
    t["gather dispatch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm = pipe.fetch_pcm(h)
    t["pcm fetch+expand"] = time.perf_counter() - t0
    t["TOTAL"] = sum(v for k, v in t.items())
    print({k: round(v * 1e3, 1) for k, v in t.items()},
          "F =", ac.shape[0], "pcm", pcm.shape)
