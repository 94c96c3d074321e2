"""Sharded multi-device family programs (SURVEY §2.8 mapping): the
DMR voice, P25p2 voice, and P25p1 control-channel chains each run as
ONE SPMD program under shard_map over a channel mesh, decoding real
(synthesized / fixture) signals — not just the dryrun's noise."""

import numpy as np
import pytest
import jax

if len(jax.devices()) < 2:          # conftest forces the 8-device CPU mesh
    pytest.skip("needs a multi-device mesh", allow_module_level=True)

from jax.sharding import Mesh

pytestmark = pytest.mark.slow      # full-tier only (docs/testing.md)


def _mesh(n=None):
    devs = jax.devices()
    n = n or min(len(devs), 8)
    return Mesh(np.array(devs[:n]), axis_names=("ch",)), n


def test_sharded_dmr_voice_decodes_synth_stream():
    from dsdneo_tpu.engine.dmrbatch import synth_voice_stream
    from dsdneo_tpu.parallel.mesh import make_sharded_dmr_voice_step
    mesh, n = _mesh()
    iqs, _dib, _bits = synth_voice_stream(n_superframes=2, seed=3)
    iq1 = np.stack([iqs.real, iqs.imag], axis=-1).astype(np.float32)
    C = n
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    B = iq.shape[1]
    step, shard = make_sharded_dmr_voice_step(mesh, C, B, max_sf=2)
    pcm, fleet = step(jax.device_put(iq, shard))
    pcm = np.asarray(pcm)
    assert np.isfinite(float(fleet))
    # every channel decodes real voice (non-silent on all shards)
    assert (np.abs(pcm).max(axis=1) > 1e-4).all()
    # 1-device layout produces the same channel-0 audio (layout
    # invariance of the SPMD program)
    mesh1, _ = _mesh(1)
    step1, shard1 = make_sharded_dmr_voice_step(mesh1, C, B, max_sf=2)
    pcm1, _ = step1(jax.device_put(iq, shard1))
    np.testing.assert_allclose(pcm[0], np.asarray(pcm1)[0], atol=2e-3)


def test_sharded_p2_voice_decodes_synth_stream():
    from dsdneo_tpu.engine.p2batch import synth_p2_voice_stream
    from dsdneo_tpu.parallel.mesh import make_sharded_p2_voice_step
    mesh, n = _mesh()
    iqs, _dib, _bits = synth_p2_voice_stream(n_superframes=2, seed=1)
    iq1 = np.stack([iqs.real, iqs.imag], axis=-1).astype(np.float32)
    C = n
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    B = iq.shape[1]
    step, shard = make_sharded_p2_voice_step(mesh, C, B, max_frames=2)
    pcm, fleet = step(jax.device_put(iq, shard))
    pcm = np.asarray(pcm)                      # [2C, T]
    assert np.isfinite(float(fleet))
    assert pcm.shape[0] == 2 * C
    # both TDMA slots of every channel carry voice
    assert (np.abs(pcm).max(axis=1) > 1e-4).all()


def test_sharded_p25_cc_decodes_fixture_tsbks():
    from dsdneo_tpu.io import read_iq_capture
    from dsdneo_tpu.parallel.mesh import make_sharded_p25_cc_step
    meta, samples = read_iq_capture(
        "/root/reference/tests/fixtures/iq/p25p1_c4fm_cc.iq.json")
    fs = float(meta.sample_rate_hz)
    B = int(fs)                                 # 1 s slice
    sl = samples[:B]
    iq1 = np.stack([sl.real, sl.imag], axis=-1).astype(np.float32)
    mesh, n = _mesh()
    C = n
    iq = np.broadcast_to(iq1[None], (C,) + iq1.shape).copy()
    step, shard = make_sharded_p25_cc_step(mesh, C, B, fs=fs,
                                           max_tsdus=4)
    blob, valid, ok_count = step(jax.device_put(iq, shard))
    blob = np.asarray(blob)
    valid = np.asarray(valid)
    # the CC fixture carries ~13 TSDU/s: every channel sees CRC-valid
    # TSBKs, and the psum'd fleet counter agrees with the local masks
    ok_local = (blob[:, :, 12] * valid).sum() \
        + (blob[:, :, 12 + 38] * valid).sum() \
        + (blob[:, :, 12 + 76] * valid).sum()
    assert int(ok_count) == int(ok_local) > 0
    # host parse of one CRC-valid payload emits real trunking events
    from dsdneo_tpu.protocol.base import DecoderContext
    from dsdneo_tpu.protocol.p25.phase1 import P25P1Decoder
    from dsdneo_tpu.symbols import framesync
    c, k = np.argwhere((valid > 0) & (blob[:, :, 12] > 0))[0]
    bits96 = np.unpackbits(blob[c, k, :12])
    ctx = DecoderContext()
    hit_def = next(d for d in framesync.SYNC_DEFS if d.name == "+P25p1")
    hit = framesync.SyncHit(pos=0, score=1.0, sync=hit_def)
    P25P1Decoder()._tsbk(bits96, hit, ctx)
    assert ctx.events, "CRC-valid TSBK parsed no events"


def test_dcn_two_process_dryrun():
    """Multi-host axis: two jax.distributed processes (4 virtual CPU
    devices each) run the channel-sharded step over one 8-wide global
    mesh; the psum'd fleet power must span the DCN (tools/dcn_dryrun.py
    asserts it equals the global-input reduction)."""
    import os
    import socket
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "tools", "dcn_dryrun.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)      # each process sets its own count
    procs = [subprocess.Popen(
        [sys.executable, script, str(pid), "2", coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    assert all("DCN_OK" in o for o in outs)
