"""Multi-device scaling: shard the channel axis over a device mesh.

The decode workload is embarrassingly parallel over channels — the
reference's equivalent of "many processes, one channel each"
(SURVEY.md §2.8) — so the natural mesh layout is channels over devices
with NO cross-channel collectives in the hot path.  ``shard_map`` runs
the SAME single-device program on each device's channel shard (the
production pattern), and collectives appear only for fleet-level
metrics (a psum of power counters across devices).

Two sharded steps exist:

- ``make_sharded_frontend``: the demod front end alone (the round-1
  contract, kept for the lightweight dryrun path);
- ``make_sharded_voice_step``: the FULL voice device program — front
  end → sync matched filter → device top-k → BCH NID → LDU frame
  gather → IMBE ECC → dequantization → harmonic synthesis — under the
  mesh.  LDU selection uses fixed-capacity device-side picking (the
  top ``max_ldus`` sync candidates per channel, validity-masked by
  DUID), so the whole chain stays one SPMD program with no host in the
  loop.

``dryrun_multichip`` is the driver contract: build an N-device mesh,
jit both sharded steps, run one step of each on tiny shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dsdneo_tpu.dsp import firdes
from dsdneo_tpu.engine.batched import frontend_step
from dsdneo_tpu.engine.modes import MODES


def make_sharded_frontend(mesh: Mesh, mode_name: str, C: int, B: int,
                          fs: float = 48000.0):
    """Jitted ``[C, B]`` step with channels sharded over mesh axis 'ch'.

    Returns (step_fn, input_sharding).  The step also returns a
    fleet-aggregate mean power (a psum across the mesh — exercising the
    collective path).
    """
    mode = MODES[mode_name]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)

    in_shard = NamedSharding(mesh, P("ch", None, None))  # [C, B, 2] I/Q planes
    out_shard = (NamedSharding(mesh, P("ch", None)),
                 NamedSharding(mesh, P("ch", None)),
                 NamedSharding(mesh, P("ch")),
                 NamedSharding(mesh, P()))

    @partial(jax.jit, in_shardings=in_shard, out_shardings=out_shard)
    def step(iq):
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        fleet_power = jnp.mean(power)   # cross-device mean → all-reduce
        return dibits, soft, power, fleet_power

    return step, in_shard


def _p25_voice_body(Cl: int, B: int, fs: float = 48000.0,
                    max_ldus: int = 2, sync_threshold: float = 0.62,
                    axis: str = "ch"):
    """Traceable per-shard body of the FULL P25p1 voice chain: maps
    [Cl, B, 2] I/Q planes → ([Cl, max_ldus·9·160] PCM, [Cl] power).
    Meant to run INSIDE shard_map over mesh axis ``axis`` (the
    prediction-state carry is pcast device-varying against it)."""
    from dsdneo_tpu.engine.voicebatch import (LDU_DATA_DIBITS,
                                              LDU_IMBE_OFFSETS,
                                              _status_strip_map,
                                              _sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.fec import blockcodes
    from dsdneo_tpu.vocoder.device import voice_decode_gather

    mode = MODES["p25p1"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+P25p1", "-P25p1")
    defs, _, _, n_max_pat = _sync_kernel(names)
    n_pat = len(defs[0].pattern)
    nid_strip = _status_strip_map(n_pat, 32).astype(np.int32)
    strip = _status_strip_map(n_pat, 32 + LDU_DATA_DIBITS)
    frame_offs = np.stack([strip[32 + o:32 + o + 72]
                           for o in LDU_IMBE_OFFSETS]).astype(np.int32)
    need = int(strip[-1]) + 1
    bch_pm = blockcodes.bch_63_16().pm.astype(np.float32)
    K = max_ldus
    n_steps = K * 9
    # static frame index maps for the fixed-capacity LDU layout
    fch_base = np.repeat(np.arange(Cl * K) // K, 9).astype(np.int32)
    forder = np.tile(np.repeat(np.arange(K), 9) * 9
                     + np.tile(np.arange(9), K), Cl).astype(np.int32)

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        best_def = jnp.argmax(sc, axis=1)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)            # [Cl, K]
        # device NID decode at the candidate positions
        gpos = jnp.clip(idx[:, :, None] + jnp.asarray(nid_strip),
                        0, dibits.shape[1] - 1)
        nd = dibits[jnp.arange(Cl)[:, None, None], gpos]
        b64 = jnp.stack([(nd >> 1) & 1, nd & 1], axis=-1
                        ).reshape(Cl, K, 64)
        s = (1.0 - 2.0 * b64[..., :63].astype(jnp.float32))
        msg = jnp.argmax(s.reshape(-1, 63) @ jnp.asarray(bch_pm).T,
                         axis=-1).reshape(Cl, K)
        duid = msg & 0xF
        inv = jnp.take_along_axis(best_def, idx, axis=1) & 1
        valid = ((vals >= sync_threshold)
                 & ((duid == 5) | (duid == 10))
                 & (inv == 0)
                 & (idx + need < n_sym))            # [Cl, K]
        ldu_ch = jnp.where(valid,
                           jnp.arange(Cl)[:, None],
                           Cl).reshape(-1).astype(jnp.int32)
        ldu_pos = idx.reshape(-1).astype(jnp.int32)
        # invalid candidates scatter to the drop row (see _dmr_voice_body)
        fch = jnp.where(jnp.repeat(valid.reshape(-1), 9),
                        jnp.asarray(fch_base), Cl).astype(jnp.int32)
        # fresh prediction state, marked device-varying so the scan
        # carry types match under shard_map's varying-axis check
        prev_logm = jax.lax.pcast(jnp.zeros((Cl, 56), jnp.float32),
                                  (axis,), to="varying")
        prev_L = jax.lax.pcast(jnp.zeros(Cl, jnp.int32), (axis,),
                               to="varying")
        pcm, _logm, _L, _synth, _aux = voice_decode_gather(
            dibits, ldu_ch, ldu_pos, jnp.asarray(frame_offs),
            fch, jnp.asarray(forder),
            prev_logm, prev_L, Cl, n_steps)
        return pcm.reshape(Cl, -1), power

    return body


def make_sharded_voice_step(mesh: Mesh, C: int, B: int,
                            fs: float = 48000.0, max_ldus: int = 2,
                            sync_threshold: float = 0.62):
    """The FULL P25p1 voice chain as one SPMD program over the mesh.

    Each device decodes its local channel shard end to end (front end,
    sync correlation, NID, LDU gather, IMBE ECC, dequantization,
    synthesis — the voicebatch/voice_decode_gather chain) and a psum
    aggregates fleet power.  Returns (step_fn, input_sharding); the
    step maps [C, B, 2] I/Q → ([C, max_ldus·9·160] PCM, fleet_power).
    """
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert C % n_dev == 0, "channel count must divide the mesh"
    body = _p25_voice_body(C // n_dev, B, fs, max_ldus, sync_threshold)

    def local_step(iq):                     # [Cl, B, 2] per device
        pcm, power = body(iq)
        fleet_power = jax.lax.pmean(jnp.mean(power), "ch")
        return pcm, fleet_power

    in_shard = NamedSharding(mesh, P("ch", None, None))
    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=P("ch", None, None),
        out_specs=(P("ch", None), P())))
    return step, in_shard


def _dmr_voice_body(Cl: int, B: int, fs: float = 48000.0,
                    max_sf: int = 2, sync_threshold: float = 0.62):
    """Traceable per-shard body of the FULL DMR BS voice chain: maps
    [Cl, B, 2] I/Q planes → ([Cl, max_sf·18·160] PCM, [Cl] power).

    Fixed-capacity device-side picking replaces the host superframe
    walk: the top ``max_sf`` voice-sync candidates per channel,
    validity-masked by score AND the VC2+VC3 EMB confidence gate
    (≤2 summed QR(16,7,6) bit errors — dmr_bs.c
    check_dmr_bs_emb_and_confidence)."""
    from dsdneo_tpu.engine.dmrbatch import (SF_EXTENT, _sf_frame_offsets,
                                            SF_PERIOD,
                                            dmr_voice_decode_gather)
    from dsdneo_tpu.engine.voicebatch import (_sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.fec import blockcodes

    mode = MODES["dmr"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+DMR BS voice", "-DMR BS voice")
    qr_cb = blockcodes.qr_16_7_6().codebook            # [128, 16]
    offs = _sf_frame_offsets()
    K = max_sf
    fch_base = np.repeat(np.arange(Cl * K) // K, 18).astype(np.int32)
    forder = np.tile(np.repeat(np.arange(K), 18) * 18
                     + np.tile(np.arange(18), K), Cl).astype(np.int32)

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        best_def = jnp.argmax(sc, axis=1)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        inv = (jnp.take_along_axis(best_def, idx, axis=1) & 1
               ).astype(jnp.uint8)
        # EMB confidence on device (same gate as the host pick)
        Tn = dibits.shape[1]
        errs_tot = jnp.zeros(idx.shape, jnp.int32)
        cb = jnp.asarray(qr_cb)
        pm = jnp.asarray((1.0 - 2.0 * qr_cb).astype(np.float32))
        offs16 = jnp.concatenate([jnp.arange(4), jnp.arange(20, 24)])
        for burst in (1, 2):
            base = jnp.clip(idx + SF_PERIOD * burst, 0, Tn - 25)
            gp = base[:, :, None] + offs16[None, None]
            dd = dibits[jnp.arange(Cl)[:, None, None], gp]
            dd = dd ^ (inv[:, :, None] * 2)
            b16 = jnp.stack([(dd >> 1) & 1, dd & 1],
                            axis=-1).reshape(Cl, -1, 16)
            s = 1.0 - 2.0 * b16.astype(jnp.float32)
            m = jnp.argmax(jnp.einsum("ckb,eb->cke", s, pm,
                                      precision=jax.lax.Precision.HIGHEST),
                           axis=-1)
            errs_tot += jnp.sum(cb[m] != b16, axis=-1).astype(jnp.int32)
        valid = ((vals >= sync_threshold) & (errs_tot <= 2)
                 & (idx >= 54) & (idx + SF_EXTENT < n_sym))
        sf_ch = jnp.where(valid, jnp.arange(Cl)[:, None], Cl
                          ).reshape(-1).astype(jnp.int32)
        sf_pos = idx.reshape(-1).astype(jnp.int32)
        sf_inv = inv.reshape(-1).astype(jnp.int32)
        # invalid candidates scatter to the drop row: their gathered
        # dibits are arbitrary (an all-zero run is a valid zero
        # codeword) and must not synthesize phantom audio
        fch = jnp.where(jnp.repeat(valid.reshape(-1), 18),
                        jnp.asarray(fch_base), Cl).astype(jnp.int32)
        wire, _st = dmr_voice_decode_gather(
            dibits, sf_ch, sf_pos, sf_inv, jnp.asarray(offs),
            fch, jnp.asarray(forder), Cl, K * 18)
        return wire.astype(jnp.float32).reshape(Cl, -1), power

    return body


def make_sharded_dmr_voice_step(mesh: Mesh, C: int, B: int,
                                fs: float = 48000.0, max_sf: int = 2,
                                sync_threshold: float = 0.62):
    """The FULL DMR BS voice chain as one SPMD program over the mesh
    (sharded counterpart of engine.dmrbatch.BatchedDmrVoicePipeline;
    see _dmr_voice_body for the per-shard chain).  Maps [C, B, 2] I/Q
    → ([C, max_sf·18·160] PCM, fleet_power)."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert C % n_dev == 0, "channel count must divide the mesh"
    body = _dmr_voice_body(C // n_dev, B, fs, max_sf, sync_threshold)

    def local_step(iq):                     # [Cl, B, 2] per device
        wire, power = body(iq)
        fleet_power = jax.lax.pmean(jnp.mean(power), "ch")
        return wire, fleet_power

    in_shard = NamedSharding(mesh, P("ch", None, None))
    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=P("ch", None, None),
        out_specs=(P("ch", None), P())))
    return step, in_shard


def _dmr_cc_body(Cl: int, B: int, fs: float = 48000.0,
                 max_csbks: int = 8, sync_threshold: float = 0.62):
    """Traceable per-shard body of DMR Tier III TSCC monitoring: maps
    [Cl, B, 2] I/Q planes → ([Cl, max_csbks, 14] uint8 CSBK blobs
    (12 payload B + crc-ok B + BPTC-err B), [Cl, max_csbks] valid,
    [Cl, max_csbks] int32 color code).

    Fixed-capacity device pick (vs the host pick_csbks walk): top-K
    data-sync candidates, slot-type Golay(20,8) typed on device, valid
    = score ∧ ≤2 Golay errors ∧ dtype==3 (CSBK).  Shoulder duplicates
    survive the mask; the host parse cache collapses them (grant
    repeats are refresh activity anyway — engine.fleettrunk)."""
    from dsdneo_tpu.engine.ccbatch import (_ST_OFFS, DMR_BURST_EXTENT,
                                           dmr_csbk_decode_device)
    from dsdneo_tpu.engine.voicebatch import (_sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.fec import blockcodes

    mode = MODES["dmr"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+DMR BS data", "+DMR BS voice")   # voice = inverted data
    g20 = blockcodes.golay_20_8()
    pm20 = (1.0 - 2.0 * g20.codebook).astype(np.float32)
    cb20 = g20.codebook
    K = max_csbks

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        inv = (jnp.take_along_axis(best_def, idx, axis=1) & 1
               ).astype(jnp.uint8)
        Tn = dibits.shape[1]
        gp = jnp.clip(idx[:, :, None] + jnp.asarray(_ST_OFFS), 0, Tn - 1)
        dd = dibits[jnp.arange(Cl)[:, None, None], gp]
        dd = dd ^ (inv[:, :, None] * 2)
        b20 = jnp.stack([(dd >> 1) & 1, dd & 1],
                        axis=-1).reshape(Cl, K, 20)
        s = 1.0 - 2.0 * b20.astype(jnp.float32)
        m = jnp.argmax(jnp.einsum("ckb,eb->cke", s, jnp.asarray(pm20),
                                  precision=jax.lax.Precision.HIGHEST),
                       axis=-1)
        errs = jnp.sum(jnp.asarray(cb20)[m] != b20, axis=-1)
        dtype = m & 0xF
        cc4 = (m >> 4) & 0xF
        valid = ((vals >= sync_threshold) & (errs <= 2) & (dtype == 3)
                 & (idx >= 54) & (idx + DMR_BURST_EXTENT < n_sym))
        ch = jnp.where(valid, jnp.arange(Cl)[:, None], Cl
                       ).reshape(-1).astype(jnp.int32)
        pos = idx.reshape(-1).astype(jnp.int32)
        blob = dmr_csbk_decode_device(dibits, ch, pos,
                                      inv.reshape(-1).astype(jnp.int32))
        return blob.reshape(Cl, K, -1), valid, cc4.astype(jnp.int32)

    return body


def _topk_shoulder_mask(idx, stride: int = 8):
    """[..., K] top-k positions (descending score) → [..., K] bool mask
    of SHOULDER candidates: candidate k within ``stride`` positions of
    a higher-scoring candidate j < k.  The device form of the host
    picks' shoulder refinement (a short sync correlates almost as well
    one symbol off-center; without suppression shoulders eat the
    fixed-capacity candidate slots)."""
    K = idx.shape[-1]
    d = jnp.abs(idx[..., :, None] - idx[..., None, :])     # [..., k, j]
    earlier = jnp.tril(jnp.ones((K, K), bool), -1)         # j < k
    return jnp.any((d < stride) & earlier, axis=-1)


def _nxdn_voice_body(Cl: int, B: int, fs: float = 48000.0,
                     max_frames: int = 4, sync_threshold: float = 0.55,
                     mode_name: str = "nxdn48"):
    """Traceable per-shard body of the NXDN voice chain: maps
    [Cl, B, 2] I/Q planes → ([Cl, max_frames·4·160] PCM, [Cl] power).

    Fixed-capacity device pick replacing the host
    nxdnbatch.pick_frames walk: top ``max_frames`` FSW candidates per
    channel, shoulder-suppressed on device, gated by the parity-valid
    full-voice LICH LUT (decoded from device-gathered descrambled
    bytes); descramble + AMBE ECC + dequant + synthesis are the
    production nxdn_voice_decode_gather program (reference
    nxdn_voice.c / nxdn_descramble.c)."""
    from dsdneo_tpu.engine.nxdnbatch import (FRAME_DIBITS,
                                             _LICH_FULL_VOICE_LUT,
                                             _voice_tables,
                                             nxdn_voice_decode_gather)
    from dsdneo_tpu.engine.voicebatch import (_sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.protocol.nxdn.decoder import _pn9_scramble_positions

    mode = MODES[mode_name]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+NXDN FSW", "-NXDN FSW")
    offs, flips = _voice_tables()
    sp = set(_pn9_scramble_positions().tolist())
    lich_flip = np.asarray([1 if i in sp else 0 for i in range(8)],
                           np.uint8)
    w8 = np.asarray([1 << (7 - i) for i in range(8)], np.int32)
    K = max_frames
    fch_base = np.repeat(np.arange(Cl * K) // K, 4).astype(np.int32)
    forder = np.tile(np.repeat(np.arange(K), 4) * 4
                     + np.tile(np.arange(4), K), Cl).astype(np.int32)

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        inv = (jnp.take_along_axis(best_def, idx, axis=1) & 1
               ).astype(jnp.uint8)
        # per-candidate LICH byte: 8 dibits after the FSW, descrambled
        # + polarity-corrected, high bit of each dibit
        Tn = dibits.shape[1]
        gp = jnp.clip(idx[:, :, None] + 10 + jnp.arange(8), 0, Tn - 1)
        dd = dibits[jnp.arange(Cl)[:, None, None], gp]
        dd = dd ^ (inv[:, :, None] * 2) \
            ^ (jnp.asarray(lich_flip)[None, None] * 2)
        lich = jnp.sum(((dd >> 1) & 1).astype(jnp.int32)
                       * jnp.asarray(w8), axis=-1)     # [Cl, K]
        valid = ((vals >= sync_threshold)
                 & jnp.asarray(_LICH_FULL_VOICE_LUT)[lich]
                 & ~_topk_shoulder_mask(idx)
                 & (idx + FRAME_DIBITS < n_sym))
        f_ch = jnp.where(valid, jnp.arange(Cl)[:, None], Cl
                         ).reshape(-1).astype(jnp.int32)
        f_pos = idx.reshape(-1).astype(jnp.int32)
        f_inv = inv.reshape(-1).astype(jnp.int32)
        fch = jnp.where(jnp.repeat(valid.reshape(-1), 4),
                        jnp.asarray(fch_base), Cl).astype(jnp.int32)
        wire, _st = nxdn_voice_decode_gather(
            dibits, f_ch, f_pos, f_inv, jnp.asarray(offs),
            jnp.asarray(flips), fch, jnp.asarray(forder), Cl, K * 4)
        return wire.astype(jnp.float32).reshape(Cl, -1), power

    return body


def _nxdn_cc_body(Cl: int, B: int, fs: float = 48000.0,
                  max_cacs: int = 8, sync_threshold: float = 0.55,
                  mode_name: str = "nxdn48"):
    """Traceable per-shard body of NXDN Type-C RCCH monitoring: maps
    [Cl, B, 2] I/Q planes → ([Cl, max_cacs, 23] uint8 CAC blobs
    (22 packed payload bytes + crc-ok), [Cl, max_cacs] valid,
    [Cl, max_cacs] int32 LICH).  Fixed-capacity device pick gated by
    the parity-valid CAC-profile LICH LUT; depermute/depuncture +
    batched K=5 Viterbi + affine CRC16-CAC screen are the production
    nxdn_cac_decode_device program (reference nxdn CAC path)."""
    from dsdneo_tpu.engine.ccbatch import nxdn_cac_decode_device
    from dsdneo_tpu.engine.nxdnbatch import (FRAME_DIBITS,
                                             _lich_parity_ok)
    from dsdneo_tpu.engine.voicebatch import (_sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.protocol.nxdn.decoder import _pn9_scramble_positions

    mode = MODES[mode_name]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+NXDN FSW", "-NXDN FSW")
    sp = set(_pn9_scramble_positions().tolist())
    lich_flip = np.asarray([1 if i in sp else 0 for i in range(8)],
                           np.uint8)
    w8 = np.asarray([1 << (7 - i) for i in range(8)], np.int32)
    # parity-valid AND CAC-bearing profile (BatchedNxdnControlPipeline
    # _CAC_LICH), over all 256 LICH byte values
    cac_lut = np.asarray([_lich_parity_ok(v) and (v >> 1) in (0x01, 0x05)
                          for v in range(256)], bool)
    K = max_cacs

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        inv = (jnp.take_along_axis(best_def, idx, axis=1) & 1
               ).astype(jnp.uint8)
        Tn = dibits.shape[1]
        gp = jnp.clip(idx[:, :, None] + 10 + jnp.arange(8), 0, Tn - 1)
        dd = dibits[jnp.arange(Cl)[:, None, None], gp]
        dd = dd ^ (inv[:, :, None] * 2) \
            ^ (jnp.asarray(lich_flip)[None, None] * 2)
        lich = jnp.sum(((dd >> 1) & 1).astype(jnp.int32)
                       * jnp.asarray(w8), axis=-1)     # [Cl, K]
        valid = ((vals >= sync_threshold)
                 & jnp.asarray(cac_lut)[lich]
                 & (inv == 0)      # CAC decode gathers upright dibits
                 & ~_topk_shoulder_mask(idx)
                 & (idx + FRAME_DIBITS < n_sym))
        ch = jnp.where(valid, jnp.arange(Cl)[:, None], Cl
                       ).reshape(-1).astype(jnp.int32)
        pos = idx.reshape(-1).astype(jnp.int32)
        blob = nxdn_cac_decode_device(dibits, ch, pos)  # [Cl*K, 23]
        return blob.reshape(Cl, K, -1), valid, lich

    return body


def _edacs_cc_body(Cl: int, B: int, fs: float = 48000.0,
                   max_frames: int = 8, sync_threshold: float = 0.62):
    """Traceable per-shard body of EDACS trunking CC monitoring: maps
    [Cl, B, 2] I/Q planes → ([Cl, max_frames, 12] uint8 blobs (msg1
    4B + msg2 4B + ok + inv + pad), [Cl, max_frames] valid,
    [Cl, max_frames] int32 polarity).  Power-gated front end (EDACS
    2-level GFSK needs the windowed level discipline), top-K sync
    pick, and the dual-polarity 2-of-3 vote + BCH(40,28) screen of
    edacs_cc_decode_device (reference edacs_process_valid_frame)."""
    from dsdneo_tpu.engine.ccbatch import edacs_cc_decode_device
    from dsdneo_tpu.engine.demod import gated_frontend_step
    from dsdneo_tpu.engine.voicebatch import (_sync_kernel,
                                              correlate_syncs_device)

    mode = MODES["edacs"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+EDACS", "-EDACS")
    defs, _, _, _ = _sync_kernel(names)
    n_pat = len(defs[0].pattern)
    K = max_frames

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft = gated_frontend_step(iq, taps, sps, n_sym,
                                           mode.four_level)
        sc = correlate_syncs_device(jnp.clip(soft, -3.5, 3.5), names)
        best_def = jnp.argmax(sc, axis=1).astype(jnp.uint8)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        valid = ((vals >= sync_threshold)
                 & ~_topk_shoulder_mask(idx)
                 & (idx + n_pat + 240 < n_sym))
        ch = jnp.where(valid, jnp.arange(Cl)[:, None], Cl
                       ).reshape(-1).astype(jnp.int32)
        pos = (idx + n_pat).reshape(-1).astype(jnp.int32)
        blob = edacs_cc_decode_device(dibits, ch, pos)  # [Cl*K, 12]
        blob = blob.reshape(Cl, K, -1)
        inv = jnp.take_along_axis(best_def, idx, axis=1)
        return blob, valid, inv.astype(jnp.int32)

    return body


def _analog_voice_body(fs: float = 48000.0):
    """Traceable per-shard body of the batched analog NBFM voice
    chain (EDACS working channels): maps [Cl, B, 2] I/Q planes →
    ([Cl, B//6] 8 kHz PCM, [Cl] power).  Channel LPF → FM
    discriminator → squelch → voice band → 6:1 decimate, the
    engine.analogbatch program (reference dsd_analog.c + edacs.c
    analog voice following)."""
    from dsdneo_tpu.engine.analogbatch import analog_voice_decode

    def body(iq):                           # [Cl, B, 2] per device
        power = jnp.mean(iq.astype(jnp.float32) ** 2, axis=(1, 2))
        return analog_voice_decode(iq, fs=fs), power

    return body


def _p2_voice_body(Cl: int, B: int, fs: float = 48000.0,
                   max_frames: int = 2, wacn: int = 0xBEE00,
                   sysid: int = 0x14C, nac: int = 0x140,
                   sync_threshold: float = 0.62):
    """Traceable per-shard body of the P25 Phase 2 TDMA voice chain
    (clear-voice path): maps [Cl, B, 2] I/Q planes →
    ([2·Cl, max_frames·8·160] per-slot PCM, [Cl] power).  Fixed-
    capacity device frame walk: the top ``max_frames`` sync candidates
    per channel; each candidate's 4 timeslots are DUID-typed by
    nearest-codeword ML and its superframe row comes from the TS0 ISCH
    location word (decoded on device against the 128-entry ISCH
    codebook) — the dense-voice fast path; off-air edge cases
    (mid-superframe entry, 2V rows without a location word) stay on
    the host pipeline."""
    from dsdneo_tpu.engine.p2batch import (TS_DIBITS, DUID_DIBITS,
                                           FRAME_DIBITS, ISCH_DIBIT0,
                                           p2_voice_decode_gather)
    from dsdneo_tpu.engine.voicebatch import (_sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.protocol.p25 import p2_xcch
    from dsdneo_tpu.protocol.p25.phase2 import DUID_CANONICAL

    C2 = 2 * Cl
    mode = MODES["p25p2"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+P25p2",)
    defs, _, _, _ = _sync_kernel(names)
    n_pat = len(defs[0].pattern)
    scr_tab = p2_xcch.generate_scramble_bits(
        wacn, sysid, nac, 12 * 360 + 380).astype(np.uint8)
    # ISCH codebook as ±1 bit matrix for ML decode + value table
    isch_items = sorted(p2_xcch._isch_table().items())
    isch_bits = np.array([[(w >> (39 - i)) & 1 for i in range(40)]
                          for w, _v in isch_items], np.float32)
    isch_vals = np.array([v for _w, v in isch_items], np.int32)
    duid_bits = np.array([[(c >> (7 - i)) & 1 for i in range(8)]
                          for c in DUID_CANONICAL], np.float32)
    K = max_frames
    # static per-frame index maps: K candidates × 4 TS × 4 frames per
    # channel, in (channel, candidate, TS, frame) order; slot s
    # collects 8 frames per candidate (2 TS × 4)
    ts_i = np.tile(np.repeat(np.arange(4), 4), Cl * K)       # TS of frame
    off_i = np.tile(np.arange(4), Cl * K * 4)                # frame in TS
    cand_i = np.tile(np.repeat(np.arange(K), 16), Cl)        # candidate
    ch_i = np.repeat(np.arange(Cl), K * 16)
    f_offidx = off_i.astype(np.int32)
    f_ord = (cand_i * 8 + (ts_i // 2) * 4 + off_i).astype(np.int32)
    # flat index into duid[Cl, K, 4] per frame
    duid_idx = ((ch_i * K + cand_i) * 4 + ts_i).astype(np.int32)

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        Tn = dibits.shape[1]
        rows_c = jnp.arange(Cl)[:, None, None, None]
        # DUID per TS: 4 dibits → 8 bits, ML vs the 16 codewords
        gp_d = jnp.clip(idx[:, :, None, None] + n_pat
                        + TS_DIBITS * jnp.arange(4)[None, None, :, None]
                        + jnp.asarray(DUID_DIBITS)[None, None, None],
                        0, Tn - 1)
        dq4 = dibits[rows_c, gp_d]                     # [Cl, K, 4, 4]
        b8 = jnp.stack([(dq4 >> 1) & 1, dq4 & 1],
                       axis=-1).reshape(Cl, K, 4, 8)
        s8 = 1.0 - 2.0 * b8.astype(jnp.float32)
        duid = jnp.argmax(jnp.einsum("ckts,ds->cktd", s8,
                                     1.0 - 2.0 * jnp.asarray(duid_bits),
                                     precision=jax.lax.Precision.HIGHEST),
                          axis=-1)                     # [Cl, K, 4]
        # TS0 ISCH → superframe row (location words only)
        gp_i = jnp.clip(idx[:, :, None] + n_pat + ISCH_DIBIT0
                        + jnp.arange(20)[None, None], 0, Tn - 1)
        di = dibits[jnp.arange(Cl)[:, None, None], gp_i]  # [Cl, K, 20]
        b40 = jnp.stack([(di >> 1) & 1, di & 1],
                        axis=-1).reshape(Cl, K, 40)
        s40 = 1.0 - 2.0 * b40.astype(jnp.float32)
        mi = jnp.argmax(jnp.einsum("cks,es->cke", s40,
                                   1.0 - 2.0 * jnp.asarray(isch_bits),
                                   precision=jax.lax.Precision.HIGHEST),
                        axis=-1)
        v = jnp.asarray(isch_vals)[mi]                 # [Cl, K]
        sfv = (v >> 3) & 3
        loc_ok = (((v >> 5) & 3) == 1) & (sfv <= 2)
        row0 = sfv * 4                                 # TS0 row
        cand_ok = ((vals >= sync_threshold) & loc_ok
                   & (idx + FRAME_DIBITS < n_sym))     # [Cl, K]
        # flatten to per-frame arrays [Cl*K*16]
        duid_f = duid.reshape(-1)[jnp.asarray(duid_idx)]
        voice4 = duid_f == 0                           # 4V timeslots
        ok_f = jnp.repeat(cand_ok.reshape(-1), 16) & voice4
        f_ch = jnp.where(ok_f, jnp.asarray(ch_i), Cl).astype(jnp.int32)
        tpos = (jnp.repeat(idx.reshape(-1), 16) + n_pat
                + TS_DIBITS * jnp.asarray(ts_i)).astype(jnp.int32)
        f_row = ((jnp.repeat(row0.reshape(-1), 16)
                  + jnp.asarray(ts_i)) % 12).astype(jnp.int32)
        f_out = jnp.where(ok_f,
                          2 * jnp.asarray(ch_i) + (jnp.asarray(ts_i) % 2),
                          C2).astype(jnp.int32)
        ks = jnp.zeros((f_ch.shape[0], 7), jnp.uint8)  # clear voice
        wire, _st = p2_voice_decode_gather(
            dibits, jnp.asarray(scr_tab), f_ch, tpos, f_row,
            jnp.asarray(f_offidx), f_out, jnp.asarray(f_ord), ks,
            C2, K * 8)
        return wire.astype(jnp.float32).reshape(C2, -1), power

    return body


def make_sharded_p2_voice_step(mesh: Mesh, C: int, B: int,
                               fs: float = 48000.0, max_frames: int = 2,
                               wacn: int = 0xBEE00, sysid: int = 0x14C,
                               nac: int = 0x140,
                               sync_threshold: float = 0.62):
    """The P25 Phase 2 TDMA voice chain as one SPMD program (sharded
    counterpart of engine.p2batch.BatchedP2VoicePipeline; see
    :func:`_p2_voice_body` for the per-shard chain).  Maps [C, B, 2]
    I/Q → ([2C, max_frames·8·160] per-slot PCM, fleet_power)."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert C % n_dev == 0, "channel count must divide the mesh"
    body = _p2_voice_body(C // n_dev, B, fs, max_frames, wacn, sysid,
                          nac, sync_threshold)

    def local_step(iq):                     # [Cl, B, 2] per device
        wire, power = body(iq)
        fleet_power = jax.lax.pmean(jnp.mean(power), "ch")
        return wire, fleet_power

    in_shard = NamedSharding(mesh, P("ch", None, None))
    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=P("ch", None, None),
        out_specs=(P("ch", None), P())))
    return step, in_shard


def _p25_cc_body(Cl: int, B: int, fs: float = 48000.0,
                 max_tsdus: int = 4, sync_threshold: float = 0.62,
                 nac_out: bool = False,
                 dedup: bool = False):
    """Traceable per-shard body of P25p1 CC monitoring: maps [Cl, B, 2]
    I/Q planes → ([Cl, max_tsdus, 114] uint8 TSDU blobs,
    [Cl, max_tsdus] valid mask[, [Cl, max_tsdus] NID msg16]).  Blob
    layout: 3 × (12 payload bytes, 1 crc-ok byte, 25 raw dibit bytes).
    """
    from dsdneo_tpu.engine.ccbatch import p25_tsdu_decode_device
    from dsdneo_tpu.engine.voicebatch import (_status_strip_map,
                                              _sync_kernel,
                                              correlate_syncs_device)
    from dsdneo_tpu.fec import blockcodes

    mode = MODES["p25p1"]
    sps = fs / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(fs, mode.lpf_profile)
    names = ("+P25p1", "-P25p1")
    defs, _, _, _ = _sync_kernel(names)
    n_pat = len(defs[0].pattern)
    nid_strip = _status_strip_map(n_pat, 32).astype(np.int32)
    tsdu_strip = _status_strip_map(n_pat, 32 + 294)
    need = int(tsdu_strip[-1]) + 1
    bch_pm = blockcodes.bch_63_16().pm.astype(np.float32)
    K = max_tsdus

    def body(iq):                           # [Cl, B, 2] per device
        dibits, soft, power = frontend_step(iq, taps, sps, n_sym,
                                            mode.four_level)
        sc = correlate_syncs_device(soft, names)
        best_def = jnp.argmax(sc, axis=1)
        bs = jnp.max(sc, axis=1)
        vals, idx = jax.lax.top_k(bs, K)               # [Cl, K]
        gpos = jnp.clip(idx[:, :, None] + jnp.asarray(nid_strip),
                        0, dibits.shape[1] - 1)
        nd = dibits[jnp.arange(Cl)[:, None, None], gpos]
        b64 = jnp.stack([(nd >> 1) & 1, nd & 1], axis=-1
                        ).reshape(Cl, K, 64)
        s = (1.0 - 2.0 * b64[..., :63].astype(jnp.float32))
        msg = jnp.argmax(s.reshape(-1, 63) @ jnp.asarray(bch_pm).T,
                         axis=-1).reshape(Cl, K)
        duid = msg & 0xF
        inv = jnp.take_along_axis(best_def, idx, axis=1) & 1
        valid = ((vals >= sync_threshold) & (duid == 7) & (inv == 0)
                 & (idx + need < n_sym))               # [Cl, K]
        if dedup:
            # shoulder suppression (see _topk_shoulder_mask): frees
            # fixed-capacity slots for distinct TSDUs when K is tight
            valid = valid & ~_topk_shoulder_mask(idx)
        ch = jnp.where(valid, jnp.arange(Cl)[:, None], Cl
                       ).reshape(-1).astype(jnp.int32)
        pos = idx.reshape(-1).astype(jnp.int32)
        blob = p25_tsdu_decode_device(dibits, ch, pos)  # [Cl*K, 114]
        blob = blob.reshape(Cl, K, -1)
        if nac_out:
            return blob, valid, msg
        return blob, valid

    return body


def make_sharded_p25_cc_step(mesh: Mesh, C: int, B: int,
                             fs: float = 48000.0, max_tsdus: int = 4,
                             sync_threshold: float = 0.62):
    """Batched P25p1 CONTROL-CHANNEL monitoring as one SPMD program
    (sharded counterpart of engine.ccbatch.BatchedP25ControlPipeline's
    device half).  Each device shard runs front end → sync → BCH NID →
    DUID-7 gate → TSBK trellis decode + CRC16 screen; the host parses
    only the returned CRC-valid payload blobs (outside the SPMD
    program, exactly like the unsharded pipeline).  Maps [C, B, 2] →
    ([C, max_tsdus, 114] uint8 TSDU blobs, [C, max_tsdus] valid mask,
    fleet_ok_count)."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert C % n_dev == 0, "channel count must divide the mesh"
    body = _p25_cc_body(C // n_dev, B, fs, max_tsdus, sync_threshold)

    def local_step(iq):                     # [Cl, B, 2] per device
        blob, valid = body(iq)
        # fleet CRC-ok count (all 3 TSBK blocks per TSDU): a psum
        # across the mesh
        ok3 = (blob[:, :, 12] + blob[:, :, 50] + blob[:, :, 88]
               ).astype(jnp.int32)
        fleet_ok = jax.lax.psum(jnp.sum(ok3 * valid.astype(jnp.int32)),
                                "ch")
        return blob, valid, fleet_ok

    in_shard = NamedSharding(mesh, P("ch", None, None))
    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=P("ch", None, None),
        out_specs=(P("ch", None, None), P("ch", None), P())))
    return step, in_shard


def make_sharded_trunk_step(mesh: Mesh, S: int, fs: float, B: int,
                            n_cc: int = 1, n_vc: int = 2,
                            max_tsdus: int = 4, max_ldus: int = 2,
                            sync_threshold: float = 0.62,
                            trunk_mode: str = "p25p1",
                            p2_params=None):
    """Closed-loop trunking at MULTI-CHIP scale: S trunked SYSTEMS
    (one wideband stream each) sharded over the mesh, each system's
    device work — PFB row extraction, CC decode, and the full voice
    chain on the granted rows — as ONE SPMD program.

    This is the mesh-scale form of engine.fleettrunk.TrunkedFleet's
    device step (the reference's one-tuner controller thread,
    src/io/radio/rtl_sdr_fm.cpp:4665, re-expressed per SURVEY §2.8):
    row offsets are sharded DATA inputs ([S, n_cc+n_vc] int32), so the
    host control plane on each system can rewrite a voice row between
    steps — grant → retarget → decode — with zero recompiles and zero
    cross-system interference.

    ``trunk_mode`` picks the family chain:

    - "p25p1": TSBK CC + LDU/IMBE voice;
    - "dmr": Tier III CSBK TSCC + AMBE superframe voice;
    - "nxdn48"/"nxdn96": Type-C RCCH CAC + AMBE full-voice frames
      (reference nxdn_vcall_assgn_parse → trunk follow);
    - "edacs": dual-polarity BCH CC + analog NBFM working channels
      (reference edacs.c grant handling + dsd_analog.c);
    - "p25_mixed": Phase-1 TSBK CC granting TDMA channels decoded by
      the Phase-2 voice body — two slots per extraction row, PCM rows
      [S, 2·n_vc, T] (reference p25_trunk_sm.c P1-CC→P2-VC follow);
      requires ``p2_params=(wacn, sysid, nac)`` (the sharded body's
      scramble table is a static, unlike the single-chip
      TrunkedFleet's lazily-learned pipeline).

    Maps (wide [S, B, 2] I/Q planes, offs [S, n_cc+n_vc] int32 Hz from
    band center) → (cc blobs [S, n_cc, K, W] uint8 (W=114 TSDU /
    14 CSBK / 23 CAC / 12 EDACS), valid [S, n_cc, K] bool, meta
    [S, n_cc, K] int32 (P25: BCH NID msg16; DMR: color code; NXDN:
    LICH; EDACS: polarity), pcm [S, R_v, T] float32 (R_v = n_vc, or
    2·n_vc for "p25_mixed"), fleet_ok scalar).  Returns
    (step_fn, (wide_shard, offs_shard)).
    """
    from dsdneo_tpu.engine.fleettrunk import (CHANNEL_RATE,
                                              make_row_extractor_body)

    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert S % n_dev == 0, "system count must divide the mesh"
    Sl = S // n_dev
    axis = mesh.axis_names[0]
    n_ch = int(round(fs / CHANNEL_RATE))
    if abs(fs - n_ch * CHANNEL_RATE) > 1.0 or n_ch < 2:
        raise ValueError(f"fs {fs:g} must be a ≥2 multiple of 48 kHz")
    R = n_cc + n_vc
    extract = make_row_extractor_body(n_ch)
    Bp = jax.eval_shape(extract,
                        jax.ShapeDtypeStruct((B, 2), jnp.float32),
                        jax.ShapeDtypeStruct((R,), jnp.int32)).shape[1]
    vc_rows = n_vc                   # PCM rows per system
    if trunk_mode == "p25p1":
        _ccb = _p25_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                            sync_threshold, nac_out=True)
        cc_body = _ccb          # (blob, valid, meta)
        vc_body = _p25_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                  sync_threshold, axis=axis)
        ok_cols = (12, 50, 88)  # 3 TSBK crc-ok bytes per TSDU
    elif trunk_mode == "dmr":
        cc_body = _dmr_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                               sync_threshold)
        vc_body = _dmr_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                  sync_threshold)
        ok_cols = (12,)         # CSBK crc-ok byte
    elif trunk_mode in ("nxdn48", "nxdn96"):
        thr = min(sync_threshold, 0.55)      # 10-symbol FSW (see
        # BatchedNxdnVoicePipeline: correlation is only a pre-filter,
        # acceptance is the LICH gate)
        cc_body = _nxdn_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                                thr, mode_name=trunk_mode)
        vc_body = _nxdn_voice_body(Sl * n_vc, Bp, CHANNEL_RATE,
                                   max_ldus, thr,
                                   mode_name=trunk_mode)
        ok_cols = (22,)         # CRC16-CAC ok byte
    elif trunk_mode == "edacs":
        cc_body = _edacs_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                                 sync_threshold)
        vc_body = _analog_voice_body(CHANNEL_RATE)
        ok_cols = (8,)          # dual-polarity BCH ok byte
    elif trunk_mode == "p25_mixed":
        if not (p2_params and all(p2_params)):
            raise ValueError("trunk_mode='p25_mixed' needs "
                             "p2_params=(wacn, sysid, nac): the sharded "
                             "P2 body's scramble table is a static")
        cc_body = _p25_cc_body(Sl * n_cc, Bp, CHANNEL_RATE, max_tsdus,
                               sync_threshold, nac_out=True)
        w0, s0, n0 = p2_params
        vc_body = _p2_voice_body(Sl * n_vc, Bp, CHANNEL_RATE, max_ldus,
                                 w0, s0, n0, sync_threshold)
        ok_cols = (12, 50, 88)
        vc_rows = 2 * n_vc      # two TDMA slots per extraction row
    else:
        raise ValueError("trunk_mode must be 'p25p1', 'dmr', 'nxdn48', "
                         "'nxdn96', 'edacs', or 'p25_mixed' "
                         f"(got {trunk_mode!r})")

    def local_step(wide, offs):       # [Sl, B, 2], [Sl, R] per device
        rows = jax.vmap(extract)(wide, offs)       # [Sl, R, B'] complex
        planes = jnp.stack([rows.real, rows.imag], axis=-1)
        cc_iq = planes[:, :n_cc].reshape(Sl * n_cc, Bp, 2)
        vc_iq = planes[:, n_cc:].reshape(Sl * n_vc, Bp, 2)
        blob, valid, meta = cc_body(cc_iq)
        pcm, _power = vc_body(vc_iq)
        ok = sum(blob[:, :, c] for c in ok_cols).astype(jnp.int32)
        fleet_ok = jax.lax.psum(jnp.sum(ok * valid.astype(jnp.int32)),
                                axis)
        return (blob.reshape(Sl, n_cc, max_tsdus, -1),
                valid.reshape(Sl, n_cc, max_tsdus),
                meta.reshape(Sl, n_cc, max_tsdus),
                pcm.reshape(Sl, vc_rows, -1), fleet_ok)

    shards = (NamedSharding(mesh, P(axis, None, None)),
              NamedSharding(mesh, P(axis, None)))
    step = jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None)),
        out_specs=(P(axis, None, None, None), P(axis, None, None),
                   P(axis, None, None), P(axis, None, None), P())))
    return step, shards


def dryrun_multichip(n_devices: int) -> None:
    """Driver contract: N-device mesh, jit the sharded steps over real
    channel-parallel shardings, run ONE step of each on tiny shapes —
    the front end alone, then the FULL device chains of four family
    programs under the mesh: P25p1 voice (sync + NID + LDU gather +
    IMBE ECC + dequant + synthesis), DMR BS voice (EMB-gated
    superframe gather + AMBE), P25p2 TDMA voice (DUID/ISCH typing +
    descramble + AMBE), and P25p1 control-channel monitoring (TSBK
    trellis + CRC screen with a psum collective)."""
    devs = np.array(jax.devices()[:n_devices])
    assert devs.size == n_devices, (
        f"need {n_devices} devices, have {len(jax.devices())}")
    mesh = Mesh(devs, axis_names=("ch",))
    C = max(n_devices * 2, 8)          # 2+ channels per device
    B = 4800                            # 0.1 s per channel — tiny
    step, in_shard = make_sharded_frontend(mesh, "p25p1", C, B)
    rng = np.random.default_rng(0)
    iq = rng.normal(size=(C, B, 2)).astype(np.float32)
    x = jax.device_put(iq, in_shard)
    dibits, soft, power, fleet = step(x)
    jax.block_until_ready((dibits, soft, power, fleet))
    assert dibits.shape[0] == C
    assert np.isfinite(float(fleet))

    vstep, v_shard = make_sharded_voice_step(mesh, C, B)
    xv = jax.device_put(iq, v_shard)
    pcm, vfleet = vstep(xv)
    jax.block_until_ready((pcm, vfleet))
    assert pcm.shape == (C, 2 * 9 * 160)
    assert np.isfinite(np.asarray(pcm)).all()
    assert np.isfinite(float(vfleet))

    dstep, d_shard = make_sharded_dmr_voice_step(mesh, C, B)
    pcm_d, dfleet = dstep(jax.device_put(iq, d_shard))
    jax.block_until_ready((pcm_d, dfleet))
    assert pcm_d.shape == (C, 2 * 18 * 160)
    assert np.isfinite(np.asarray(pcm_d)).all()

    pstep, p_shard = make_sharded_p2_voice_step(mesh, C, B)
    pcm_p, pfleet = pstep(jax.device_put(iq, p_shard))
    jax.block_until_ready((pcm_p, pfleet))
    assert pcm_p.shape == (2 * C, 2 * 8 * 160)
    assert np.isfinite(np.asarray(pcm_p)).all()

    cstep, c_shard = make_sharded_p25_cc_step(mesh, C, B)
    blob, valid, ok_count = cstep(jax.device_put(iq, c_shard))
    jax.block_until_ready((blob, valid, ok_count))
    assert blob.shape[:2] == (C, 4) and valid.shape == (C, 4)
    assert int(ok_count) >= 0

    # closed-loop trunking at mesh scale: S systems (1 CC + 2 voice
    # rows each, offsets as sharded DATA), one SPMD program for row
    # extraction + CC TSDU decode + the full voice chain
    S = n_devices
    FS = 4 * 48000.0
    Bw = 19200                          # 0.1 s of wideband per system
    tstep, (w_shard, o_shard) = make_sharded_trunk_step(
        mesh, S, FS, Bw, n_cc=1, n_vc=2, max_tsdus=2, max_ldus=1)
    wide = rng.normal(size=(S, Bw, 2)).astype(np.float32)
    offs = np.tile(np.array([[-48000, 0, 48000]], np.int32), (S, 1))
    tb, tv, tm, tpcm, tok = tstep(jax.device_put(wide, w_shard),
                                  jax.device_put(offs, o_shard))
    jax.block_until_ready((tb, tv, tm, tpcm, tok))
    assert tb.shape == (S, 1, 2, 114) and tpcm.shape[:2] == (S, 2)
    assert np.isfinite(np.asarray(tpcm)).all() and int(tok) >= 0

    # the other trunked families' SPMD programs: NXDN Type-C (CAC K=5
    # Viterbi + LICH-gated AMBE voice) and EDACS (dual-polarity BCH CC
    # + analog NBFM working channels) — same sharded-offsets closed
    # loop, different family bodies (test_trunkmesh runs the full
    # grant→retarget→decode→release loop for all five)
    nstep, (nw_shard, no_shard) = make_sharded_trunk_step(
        mesh, S, FS, Bw, n_cc=1, n_vc=1, max_tsdus=2, max_ldus=2,
        trunk_mode="nxdn48")
    nb, nv, nm, npcm, nok = nstep(jax.device_put(wide, nw_shard),
                                  jax.device_put(offs[:, :2], no_shard))
    jax.block_until_ready((nb, nv, nm, npcm, nok))
    assert nb.shape == (S, 1, 2, 23) and npcm.shape[:2] == (S, 1)
    assert np.isfinite(np.asarray(npcm)).all() and int(nok) >= 0

    estep, (ew_shard, eo_shard) = make_sharded_trunk_step(
        mesh, S, FS, Bw, n_cc=1, n_vc=1, max_tsdus=2,
        trunk_mode="edacs")
    eb, ev, em, epcm, eok = estep(jax.device_put(wide, ew_shard),
                                  jax.device_put(offs[:, :2], eo_shard))
    jax.block_until_ready((eb, ev, em, epcm, eok))
    assert eb.shape == (S, 1, 2, 12) and epcm.shape[:2] == (S, 1)
    assert np.isfinite(np.asarray(epcm)).all() and int(eok) >= 0
