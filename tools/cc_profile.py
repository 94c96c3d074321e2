"""Warm per-stage profile of the batched P25 CC chain (C from argv)."""
import sys, time
sys.path.insert(0, "/root/repo")
import numpy as np, jax, jax.numpy as jnp
import bench
bench.enable_compile_cache()
from dsdneo_tpu.engine.ccbatch import (BatchedP25ControlPipeline,
                                       p25_tsdu_decode_device)
from dsdneo_tpu.io import read_iq_capture

meta, samples = read_iq_capture(
    "/root/reference/tests/fixtures/iq/p25p1_c4fm_cc.iq.json")
fs = float(meta.sample_rate_hz)
iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
C = int(sys.argv[1]) if len(sys.argv) > 1 else 320
x = jax.device_put(np.broadcast_to(iq1[None], (C,) + iq1.shape).copy())
pipe = BatchedP25ControlPipeline(C, fs=fs)
pipe.decode_block_events(x)
for rep in range(3):
    for ctx in pipe.ctxs:
        ctx.events.clear()
    t = {}
    t0 = time.perf_counter()
    dibits_dev, idx, vq, dq, msg, n_sym = pipe.frontend_sync_device(x)
    t["frontend+blob"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ac, at, am = pipe.pick_tsdus(idx, vq, dq, msg, n_sym,
                                 dibits_dev=dibits_dev)
    t["pick(host)"] = time.perf_counter() - t0
    H = ac.shape[0]
    t0 = time.perf_counter()
    Hp = -(-H // 64) * 64
    acp = np.full(Hp, C, dtype=np.int32); acp[:H] = ac
    atp = np.zeros(Hp, dtype=np.int32); atp[:H] = at
    blob = np.asarray(p25_tsdu_decode_device(
        dibits_dev, jnp.asarray(acp), jnp.asarray(atp)))
    t["tsdu dev+fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = blob[:H].reshape(H, 3, 38)
    n = 0
    for h in range(H):
        c, tt = int(ac[h]), int(at[h])
        for b in range(3):
            if blk[h, b, 12]:
                n += 1
                if pipe._parse_tsbk(c, tt, blk[h, b, :12]):
                    break
    t["host parse"] = time.perf_counter() - t0
    print(f"H={H} tsbk={n}  |  " +
          "  |  ".join(f"{k}: {v*1e3:.0f}ms" for k, v in t.items()),
          flush=True)
