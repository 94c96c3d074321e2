"""Parameterized chain profiler / channel-count sweep.

Replaces the round-2 scratch scripts (c_sweep*.py, fe_bisect*.py) with
one tool:

    python tools/chain_sweep.py sweep  [C1 C2 ...]   # decode_block vs C
    python tools/chain_sweep.py stages [C]           # per-stage split
    python tools/chain_sweep.py fe     [C]           # frontend bisect

Runs on JAX's default device with the persistent compile cache
enabled.
"""
import sys
import time

sys.path.insert(0, "/root/repo")
import numpy as np  # noqa: E402

import bench  # noqa: E402

bench.enable_compile_cache()


def _fixture(C):
    import jax
    fs, samples = bench.headline_capture()
    iq1 = np.stack([samples.real, samples.imag], axis=-1).astype(np.float32)
    x = jax.device_put(np.broadcast_to(iq1[None], (C,) + iq1.shape).copy())
    return fs, iq1.shape[0] / fs, x


def cmd_sweep(counts):
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    for C in counts:
        fs, block_s, x = _fixture(C)
        pipe = BatchedP25VoicePipeline(C, fs=fs, pcm_fmt="mulaw")
        pipe.decode_block(x)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            prev = pipe.decode_block_async(x)
            for _ in range(4):
                nxt = pipe.decode_block_async(x)
                pipe.fetch_pcm(prev)
                prev = nxt
            pipe.fetch_pcm(prev)
            ts.append((time.perf_counter() - t0) / 5)
        step = min(ts)
        print(f"C={C:4d}: step {step * 1e3:7.1f} ms  "
              f"{C * block_s / step:7.1f}x realtime", flush=True)


def cmd_stages(C):
    import subprocess
    subprocess.run([sys.executable, "tools/chain_profile.py", str(C)])
    subprocess.run([sys.executable, "tools/dmr_profile.py", str(C)])
    subprocess.run([sys.executable, "tools/cc_profile.py", str(C)])
    subprocess.run([sys.executable, "tools/p2_profile.py", str(C)])


def cmd_fe(C):
    """Bisect the fused frontend_sync dispatch: front end alone, +sync
    conv, +top-k, +NID codebook matmul."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.engine.voicebatch import (BatchedP25VoicePipeline,
                                              correlate_syncs_device)
    fs, block_s, x = _fixture(C)
    pipe = BatchedP25VoicePipeline(C, fs=fs)
    B = x.shape[1]
    n_sym = int(B // pipe.sps) - 2

    from dsdneo_tpu.engine.batched import frontend_step
    taps = pipe.taps

    @jax.jit
    def fe(iq):
        d, s, p = frontend_step(iq, taps, pipe.sps, n_sym, True)
        return jnp.sum(s)

    @jax.jit
    def fe_conv(iq):
        d, s, p = frontend_step(iq, taps, pipe.sps, n_sym, True)
        sc = correlate_syncs_device(s, pipe.SYNC_NAMES)
        return jnp.sum(sc)

    for name, fn in (("frontend", fe), ("+syncconv", fe_conv)):
        float(fn(x))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(fn(x))
            ts.append(time.perf_counter() - t0)
        print(f"{name}: {min(ts) * 1e3:.1f} ms", flush=True)
    t0 = time.perf_counter()
    pipe.frontend_sync_device(x)
    print(f"full fused dispatch+blob: {(time.perf_counter() - t0) * 1e3:.1f}"
          " ms", flush=True)


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "sweep"
    rest = [int(v) for v in sys.argv[2:]]
    if cmd == "sweep":
        cmd_sweep(rest or [128, 256, 320, 384])
    elif cmd == "stages":
        cmd_stages(rest[0] if rest else 320)
    elif cmd == "fe":
        cmd_fe(rest[0] if rest else 192)
    else:
        raise SystemExit(f"unknown command {cmd}")
