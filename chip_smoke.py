#!/usr/bin/env python3
"""Smoke run of the batched P25 fleet decode on one GPU.

    python chip_smoke.py              # one card, deployment size
    python chip_smoke.py --devices 4  # the sharded paths on four cards
    python chip_smoke.py --rehearse   # CPU rehearsal at a tiny size

One process drives the card.  Phases, in order; any failure raises and
the script exits non-zero:

1. device   -- JAX's default device must be a GPU; prints the card's
               name and power limit, the JAX version and device count.
2. main     -- a seeded 3 s, 48 kHz P25 Phase 1 C4FM voice capture
               (LDUs through the real IMBE ECC) written as a sidecar
               I/Q capture, decoded through ``dsdneo_tpu.cli.main``
               with ``--fleet p25p1:voice:320``; every channel must
               carry audio.
3. correct  -- ``BatchedP25VoicePipeline`` at C=320 on the same stream:
               frames and FEC bits bit-exact against the serial host
               decoder run on the CPU device of this process; PCM
               within ``PCM_TOL`` of the same pipeline run on the CPU.
4. trunk    -- ``--trunk-wideband`` through ``cli.main`` on a seeded
               768 kHz band: the grant must retarget a row and the row
               must decode voice.
5. timing   -- the C=320 decode step after warm-up (host fetch of the
               PCM ends each step): compile time as set-up, step time,
               aggregate x realtime, peak device memory.
6. tests    -- the tests marked ``gpu``, in this process.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

``--devices 4`` runs only the sharded paths and what they are compared
with: ``make_sharded_voice_step`` on a 4-card mesh against one card,
and ``ShardedTrunkedFleet`` with four systems against four
single-system runs.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")           # generated captures

# PCM agreement between the card and the CPU, as a fraction of the
# reference's peak: the f16 wire rounds to 2^-11 relative, and the
# dequantizer and synthesizer take exp/sin/cos and their sums in
# another order on each backend; 2e-2 of peak (-34 dB) stays below the
# IMBE codec's own quantization noise.
PCM_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ["nvidia-smi: not available"]
    return [ln.strip() for ln in out.splitlines() if ln.strip()] or \
        ["nvidia-smi: not available"]


def run_cli(argv: list[str]) -> tuple[int, str, float]:
    """``cli.main`` in this process; returns (rc, stderr text, seconds)."""
    from dsdneo_tpu import cli
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, err.getvalue(), time.perf_counter() - t0


def planes(x: np.ndarray, C: int) -> np.ndarray:
    iq1 = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()


def phase_main(C: int, seconds: float, platform: str, x) -> float:
    from dsdneo_tpu.io.iq import IqMetadata, write_iq_capture
    path = os.path.join(WORK, "p25p1_voice.iq")
    write_iq_capture(path, x, IqMetadata(sample_format="cf32",
                                         sample_rate_hz=48000))
    rc, err, secs = run_cli(["--frontend", "none", "--platform", platform,
                             "--fleet", f"p25p1:voice:{C}",
                             "--iq-replay", path + ".json"])
    m = re.search(r"group p25p1/voice x(\d+): ([\d.]+) s audio per "
                  r"channel, (\d+)/(\d+) rows with audio", err)
    assert rc == 0 and m, f"cli --fleet failed (rc={rc}):\n{err}"
    n_live, n_rows = int(m.group(3)), int(m.group(4))
    assert n_rows == C and n_live == C, f"silent channels: {m.group(0)}"
    log(f"[main] cli --fleet p25p1:voice:{C} on {seconds:g} s: "
        f"{m.group(2)} s audio per channel, {n_live}/{n_rows} rows with "
        f"audio; first call incl. compile {secs:.3f} s")
    return secs


def phase_correct(C: int, x) -> None:
    import jax

    from dsdneo_tpu.engine.decoder import decode_samples
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.fec import device as fdev
    from dsdneo_tpu.protocol.p25.imbe_frame import decode_imbe_ecc
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ctx = decode_samples(x, "p25p1", fs=48000.0)
        ref_pcm = BatchedP25VoicePipeline(1).decode_block(planes(x, 1))[0]
    ref = np.stack([np.asarray(f, np.uint8) for ev in ctx.events
                    if "imbe" in ev.fields for f in ev.fields["imbe"]])
    ref88 = np.stack([decode_imbe_ecc(f)[0] for f in ref])

    pipe = BatchedP25VoicePipeline(C)
    iq = jax.device_put(planes(x, C))
    dib, bd, bs, nm = pipe.frontend_sync(iq)
    f144, fch, _ford = pipe.find_voice_frames_best(dib, bd, bs,
                                                   dib.shape[1], nm)
    b88 = np.asarray(fdev.imbe_ecc_batch(f144)[0])
    counts = np.bincount(fch, minlength=C)
    n = int(counts.min())
    assert n >= 0.9 * len(ref), (n, len(ref))
    for c in range(C):
        sel = fch == c
        assert (f144[sel][:n] == ref[:n]).all(), f"frames differ, ch {c}"
        assert (b88[sel][:n] == ref88[:n]).all(), f"FEC bits differ, ch {c}"
    pcm = pipe.decode_block(iq)
    k = min(pcm.shape[1], ref_pcm.shape[0])
    err = float(np.abs(pcm[:, :k] - ref_pcm[None, :k]).max())
    peak = float(np.abs(ref_pcm).max())
    assert peak > 0 and err <= PCM_TOL * peak, (err, peak)
    log(f"[correct] C={C}: {n} of {len(ref)} serial frames per channel, "
        f"frames and FEC bits bit-exact on all {C} channels; PCM max "
        f"|err| {err:.3e} = {err / peak:.2e} x peak {peak:.3e} "
        f"(tol {PCM_TOL} x peak)")


def phase_trunk(platform: str) -> None:
    from dsdneo_tpu.io.iq import IqMetadata, write_iq_capture
    from dsdneo_tpu.protocol.p25 import encode as E
    wide = E.trunked_band(2.0, seed=0)
    path = os.path.join(WORK, "p25_band.iq")
    write_iq_capture(path, wide, IqMetadata(
        sample_format="cu8", sample_rate_hz=int(E.BAND_FS),
        center_frequency_hz=int(E.BAND_CENTER_HZ)))
    rc, err, secs = run_cli(["--frontend", "none", "--platform", platform,
                             "-f1", f"--trunk-wideband={E.BAND_CC_OFF}:4",
                             "--iq-replay", path + ".json"])
    assert rc == 0, f"cli --trunk-wideband failed (rc={rc}):\n{err}"
    assert f"GRANT TG {E.BAND_TG} -> row 0" in err, err
    m = re.search(rf"active call TG {E.BAND_TG} row 0: (\d+) voice "
                  r"samples", err)
    assert m and int(m.group(1)) > 0, f"granted row decoded no voice:\n{err}"
    log(f"[trunk] grant TG {E.BAND_TG} -> row 0 observed; row decoded "
        f"{m.group(1)} voice samples; 2 blocks incl. compile {secs:.3f} s")


def phase_timing(C: int, seconds: float, x, reps: int, card: str) -> None:
    import jax

    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    pipe = BatchedP25VoicePipeline(C)
    iq = jax.device_put(planes(x, C))
    # two warm-up blocks: the second is the first with device-resident
    # voice carry, a second program signature
    t0 = time.perf_counter()
    pipe.decode_block(iq)
    pipe.decode_block(iq)
    setup = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipe.decode_block(iq)                 # ends in the PCM fetch
        times.append(time.perf_counter() - t0)
    step = float(np.median(times))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    peak_s = f"{peak / 2**30:.3f} GiB" if peak else "not measured"
    log(f"[timing] card: {card}")
    log(f"[timing] p25p1 C={C} block {seconds:g} s: warm-up (2 blocks, "
        f"incl. compile) "
        f"{setup:.3f} s; step median {step * 1e3:.3f} ms over {reps} "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}); "
        f"aggregate {C * seconds / step:.1f}x realtime; "
        f"peak_bytes_in_use {peak_s}  [{card}]")


def phase_tests() -> None:
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu_precision.py")])
    assert rc == 0, f"gpu-marked tests failed (pytest rc={rc})"
    log("[tests] gpu-marked tests passed")


def four_devices(x, seconds: float, C: int) -> None:
    """The sharded paths on four cards against one card."""
    import jax
    from jax.sharding import Mesh

    from dsdneo_tpu.parallel.mesh import make_sharded_voice_step
    from dsdneo_tpu.parallel.trunkfleet import ShardedTrunkedFleet
    from dsdneo_tpu.protocol.p25 import encode as E
    devs = jax.devices()[:4]
    B = x.shape[0]
    max_ldus = int(seconds / 0.18) + 1
    iq = planes(x, C)
    outs = []
    for ds in (devs, devs[:1]):
        step, shard = make_sharded_voice_step(
            Mesh(np.array(ds), ("ch",)), C, B, max_ldus=max_ldus)
        pcm, power = step(jax.device_put(iq, shard))
        owners = {s.device for s in pcm.addressable_shards}
        assert owners == set(ds), f"PCM shards on {owners}, mesh {ds}"
        outs.append(np.asarray(pcm))
    err = float(np.abs(outs[0] - outs[1]).max())
    peak = float(np.abs(outs[1]).max())
    assert peak > 0 and err <= PCM_TOL * peak, (err, peak)
    log(f"[mesh] make_sharded_voice_step C={C} on 4 cards vs 1: PCM max "
        f"|err| {err:.3e} vs peak {peak:.3e}; shards on all 4 devices")

    S, fs, Bw = 4, E.BAND_FS, int(E.BAND_FS)
    wides = np.stack([E.trunked_band(2.0, seed=10 * s, tg=101 + s)
                      for s in range(S)])
    blocks = [wides[:, i * Bw:(i + 1) * Bw] for i in range(2)]

    def run(ds, sel):
        f = ShardedTrunkedFleet(Mesh(np.array(ds), ("sys",)),
                                n_systems=len(sel), fs=fs, B=Bw,
                                cc_offsets_hz=[E.BAND_CC_OFF] * len(sel),
                                n_voice_rows=2, centers_hz=E.BAND_CENTER_HZ,
                                max_ldus=8)
        f.step(blocks[0][sel])
        pcm = f.step(blocks[1][sel])
        return [{c.tg for c in calls.values()} for calls in f.calls], pcm

    tg4, pcm4 = run(devs, list(range(S)))
    for s in range(S):
        tg1, pcm1 = run(devs[:1], [s])
        assert tg4[s] == tg1[0] == {101 + s}, (s, tg4[s], tg1[0])
        k = min(pcm4.shape[-1], pcm1.shape[-1])
        e = float(np.abs(pcm4[s, :, :k] - pcm1[0, :, :k]).max())
        pk = float(np.abs(pcm1[0]).max())
        assert pk > 0 and e <= PCM_TOL * pk, (s, e, pk)
    log(f"[mesh] ShardedTrunkedFleet S={S} on 4 cards vs 4 single-system "
        f"runs: grants TG {sorted(set().union(*tg4))} match, voice PCM "
        f"within {PCM_TOL} x peak")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a tiny size (no GPU needed)")
    args = ap.parse_args(argv)

    import jax
    # the serial comparator runs on the CPU device of this process
    jax.config.update("jax_platforms", "cpu" if args.rehearse
                      else "cuda,cpu")
    if not args.rehearse:
        from dsdneo_tpu.runtime.jaxcache import enable_compile_cache
        enable_compile_cache()
    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no JAX device: {e}", file=sys.stderr)
        return 1
    dev = devs[0]
    if not args.rehearse and dev.platform != "gpu":
        print(f"chip_smoke: default device is {dev.platform}, not a GPU",
              file=sys.stderr)
        return 1
    if len(devs) < args.devices:
        print(f"chip_smoke: need {args.devices} devices, have {len(devs)}",
              file=sys.stderr)
        return 1
    cards = card_lines()
    card = cards[0]
    for ln in cards:
        log(ln)                               # nvidia-smi's name,power.limit
    log(f"jax {jax.__version__}; {len(devs)} x {dev.platform} "
        f"({dev.device_kind})")

    from dsdneo_tpu.protocol.p25 import encode as E
    os.makedirs(WORK, exist_ok=True)
    C, seconds, reps = (2, 1.0, 2) if args.rehearse else (320, 3.0, 10)
    if args.devices == 4 and args.rehearse:
        C = 8                                 # divisible by the mesh
    platform = "cpu" if args.rehearse else "gpu"
    x = E.voice_capture(seconds, seed=0)
    if args.devices == 4:
        four_devices(x, seconds, C)
    else:
        phase_main(C, seconds, platform, x)
        phase_correct(C, x)
        phase_trunk(platform)
        phase_timing(C, seconds, x, reps, card)
        if args.rehearse:
            log("[tests] skipped in a CPU rehearsal (they need the card)")
        else:
            phase_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
