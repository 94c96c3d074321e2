"""Fleet-scale closed-loop trunking (engine.fleettrunk): a CC grant
observed on a control row REWRITES a voice row's extraction offset
between device steps — zero recompiles — and the granted voice channel
decodes to PCM.  Matches the reference's controller-thread retune
(src/io/radio/rtl_sdr_fm.cpp:4665) re-expressed per SURVEY.md §2.8
("retune = rewrite a channel's NCO/config row between steps")."""

import numpy as np
import pytest

FS = 768000.0           # 16 × 48 kHz band
CENTER = 851_000_000.0
CC_OFF = -96_000        # CC at 850.904 MHz
VC_OFF = 150_000        # granted voice at 851.150 MHz
TG = 101


def _mix(parts, n):
    wide = np.zeros(n, dtype=np.complex128)
    t = np.arange(n, dtype=np.float64) / FS
    for x, off in parts:
        m = min(len(x), n)
        wide[:m] += x[:m] * np.exp(2j * np.pi * off * t[:m])
    return wide.astype(np.complex64)


def _build_wideband(seconds: float = 4.0, voice_until: float = 3.0):
    """CC stream (iden 6.25 kHz raster + grant of TG 101 on channel 24
    → 851.15 MHz) for the full capture; LDU voice on +150 kHz until
    ``voice_until``."""
    from dsdneo_tpu.protocol.p25 import encode as E
    sps = int(FS / 4800)
    nac = 0x293
    grant_ch = (1 << 12) | 24            # iden 1, ch 24 → +24·6.25 kHz
    netstat = E.tsbk_bytes(0x3B, [0, 0x92, 0x06, 0x50, 0xD5, 0, 0, 0],
                           lb=True)
    iden = E.iden_up_tsbk(1, CENTER, 6250.0)
    frame_grant = E.tsdu_frame(
        nac, [iden, E.group_grant_tsbk(grant_ch, tg=TG, src=5555), netstat])
    # grants announce only while the call sets up (first ~1 s); after
    # that the CC carries broadcast traffic only — so hangtime release
    # is driven by voice going idle, as on a real system
    frame_idle = E.tsdu_frame(nac, [iden, netstat])
    rng = np.random.default_rng(0)
    need = int(seconds * 4800)
    cc_dib = [rng.integers(0, 4, 60).astype(np.uint8)]
    total = 60
    while total < need:
        f = frame_grant if total < 4800 else frame_idle
        cc_dib.append(f)
        cc_dib.append(rng.integers(0, 4, 24).astype(np.uint8))
        total += len(f) + 24
    cc = E.c4fm_iq(np.concatenate(cc_dib)[:need], sps=sps, fs=FS, seed=1)

    n_ldus = int(voice_until / 0.185)
    ldus = E.random_voice_ldus(n_ldus, seed=3)
    vc_dib = [rng.integers(0, 4, 30).astype(np.uint8)]
    for i in range(n_ldus):
        vc_dib.append(E.ldu_frame(nac, ldus[i], duid=5 if i % 2 == 0
                                  else 10, seed=i))
    vc = E.c4fm_iq(np.concatenate(vc_dib), sps=sps, fs=FS, seed=2)
    vc = vc[:int(voice_until * FS)]

    n = int(seconds * FS)
    return _mix([(cc, CC_OFF), (vc, VC_OFF)], n)


@pytest.fixture(scope="module")
def wide():
    return _build_wideband()


def test_grant_retargets_row_and_decodes_voice(wide):
    from dsdneo_tpu.engine.fleettrunk import TrunkedFleet
    fleet = TrunkedFleet(FS, [CC_OFF], n_voice_rows=2, center_hz=CENTER,
                         hangtime_s=0.6, grant_grace_s=0.5)
    B = int(FS)                          # 1 s blocks
    blocks = [wide[i * B:(i + 1) * B] for i in range(4)]

    pcm1 = fleet.step(blocks[0])
    # the grant was observed and a row retargeted for the NEXT step
    assert fleet.stats.grants == 1
    assert 0 in fleet.calls and fleet.calls[0].tg == TG
    assert abs(fleet.calls[0].freq_hz - (CENTER + VC_OFF)) < 1.0
    assert fleet.offs[fleet.n_cc + 0] == VC_OFF
    assert pcm1.shape[1] == 0            # no call was active during it

    pcm2 = fleet.step(blocks[1])
    assert pcm2.shape[0] == 2
    e2 = np.abs(pcm2).mean(axis=1)
    assert e2[0] > 1e-3, "granted row must decode voice PCM"
    assert e2[1] < e2[0] / 10, "parked row must stay silent"

    # zero recompiles once warm: every jit cache must stay flat
    def _cache_sizes(f):
        n = f._extract._cache_size()
        for pipe in (f.cc_pipe, f.vc_pipe):
            for fn in getattr(pipe, "_frontend_jits", {}).values():
                n += fn._cache_size()
        return n

    warm = _cache_sizes(fleet)
    pcm3 = fleet.step(blocks[2])
    assert np.abs(pcm3[0]).mean() > 1e-3
    assert _cache_sizes(fleet) == warm, "retune must not recompile"
    assert fleet._extract._cache_size() == 1

    # voice ends at 3 s: the idle block releases the call, row parks
    fleet.step(blocks[3])
    assert fleet.stats.releases == 1
    assert not fleet.calls
    assert fleet.offs[fleet.n_cc + 0] == CC_OFF

    # grant repeats while the call was up refreshed, not re-granted
    assert fleet.stats.grants == 1
    assert fleet.stats.grant_refreshes >= 2


def test_cu8_wire_format_decodes(wide):
    """The SDR wire format end to end: the wideband quantized to CU8
    offset-binary planes (what librtlsdr delivers) feeds the fleet
    directly — raw bytes over the host→device link, converted on
    device by the row extractor (4x less upload than float planes);
    the grant and voice decode survive the 8-bit quantization."""
    from dsdneo_tpu.engine.fleettrunk import TrunkedFleet
    scale = np.abs(wide).max()
    pl = np.stack([wide.real, wide.imag], axis=-1) / scale
    wide_u8 = np.clip(pl * 127.5 + 127.5, 0, 255).astype(np.uint8)
    fleet = TrunkedFleet(FS, [CC_OFF], n_voice_rows=2, center_hz=CENTER,
                         hangtime_s=0.6, grant_grace_s=0.5)
    B = int(FS)
    fleet.step(wide_u8[:B])
    assert fleet.stats.grants == 1
    assert fleet.offs[fleet.n_cc + 0] == VC_OFF
    pcm = fleet.step(wide_u8[B:2 * B])
    assert np.abs(pcm[0]).mean() > 1e-3


def test_row_extractor_exact_nco():
    """A pure tone at an arbitrary integer-Hz offset extracts to (near)
    DC on its row — the integer-phase NCO stays exact over a long
    block — and rewriting the offs array retargets without recompile."""
    import jax.numpy as jnp
    from dsdneo_tpu.engine.fleettrunk import make_row_extractor
    n = int(2 * FS)                     # 2 s: float32 f·n phase would drift
    t = np.arange(n) / FS
    f1, f2 = 137_531, -201_250
    wide = (np.exp(2j * np.pi * f1 * t)
            + np.exp(2j * np.pi * f2 * t)).astype(np.complex64)
    ex = make_row_extractor(16)
    rows = np.asarray(ex(jnp.asarray(wide),
                         jnp.asarray([f1, f2], np.int32)))
    for r in range(2):
        x = rows[r][2000:-2000]
        # residual tone frequency ≈ 0: successive-sample phase steps
        dphi = np.angle(x[1:] * np.conj(x[:-1]))
        assert abs(np.mean(dphi)) * 48000 / (2 * np.pi) < 1.0, r
        assert np.abs(x).mean() > 0.1, r
    # retarget: row 0 now picks the OTHER tone; same compiled program
    rows2 = np.asarray(ex(jnp.asarray(wide),
                          jnp.asarray([f2, f1], np.int32)))
    assert ex._cache_size() == 1
    x = rows2[0][2000:-2000]
    dphi = np.angle(x[1:] * np.conj(x[:-1]))
    assert abs(np.mean(dphi)) * 48000 / (2 * np.pi) < 1.0


def test_prefetch_path_bit_identical(wide):
    """step(None, prefetch=...) double-buffering — the upload-overlap
    path bench_fleet_trunk measures — produces bit-identical PCM,
    stats, and control-plane state to the plain step(wide) path (the
    prefetch only moves the h2d upload, never the data)."""
    from dsdneo_tpu.engine.fleettrunk import TrunkedFleet
    B = int(FS)
    blocks = [wide[i * B:(i + 1) * B] for i in range(3)]

    def mk():
        return TrunkedFleet(FS, [CC_OFF], n_voice_rows=2,
                            center_hz=CENTER, hangtime_s=0.6,
                            grant_grace_s=0.5)

    plain, pre = mk(), mk()
    out_plain = [plain.step(b) for b in blocks]
    out_pre = [pre.step(blocks[0], prefetch=blocks[1]),
               pre.step(None, prefetch=blocks[2]),
               pre.step(None)]
    for a, b in zip(out_plain, out_pre):
        np.testing.assert_array_equal(a, b)
    assert plain.stats == pre.stats
    assert plain.offs.tolist() == pre.offs.tolist()
    assert {r: c.tg for r, c in plain.calls.items()} == \
        {r: c.tg for r, c in pre.calls.items()}
    # a fresh block supersedes a stale queued prefetch (never decodes
    # out of order)
    pre.step(blocks[1], prefetch=blocks[2])
    pre.step(blocks[1])
    assert pre._next_block is None
    assert any("WARN: prefetched block dropped" in line
               for line in pre.log)
    with pytest.raises(ValueError):
        pre.step(None)


def test_cc_device_pick_equivalent_control_plane(wide):
    """cc_device_pick=True replaces the host TSDU candidate pick with
    the fixed-capacity device pick (parallel.mesh._p25_cc_body,
    shoulder-suppressed) so the closed loop needs ONE d2h exchange per
    block instead of three — the control-plane outcome (grants,
    refreshes, releases, offsets, decoded voice) must match the host
    pick on the same wideband."""
    from dsdneo_tpu.engine.fleettrunk import TrunkedFleet
    B = int(FS)

    def run(flag):
        fleet = TrunkedFleet(FS, [CC_OFF], n_voice_rows=2,
                             center_hz=CENTER, hangtime_s=0.6,
                             grant_grace_s=0.5, cc_device_pick=flag)
        pcms = [fleet.step(wide[i * B:(i + 1) * B]) for i in range(4)]
        return fleet, pcms

    host, pcm_h = run(False)
    dev, pcm_d = run(True)
    assert dev.cc_device_pick and not host.cc_device_pick
    assert dev.stats.grants == host.stats.grants == 1
    assert dev.stats.releases == host.stats.releases == 1
    assert dev.stats.grant_refreshes == host.stats.grant_refreshes
    assert dev.offs.tolist() == host.offs.tolist()
    # voice rows decode the same stream (identical voice pipeline)
    for a, b in zip(pcm_h, pcm_d):
        np.testing.assert_array_equal(a, b)


def test_cc_device_pick_partial_final_block(wide):
    """The device CC pick compiles per block length: a shorter final
    block (the CLI's last partial read) gets its own program and still
    decodes the control channel."""
    from dsdneo_tpu.engine.fleettrunk import TrunkedFleet
    fleet = TrunkedFleet(FS, [CC_OFF], n_voice_rows=2, center_hz=CENTER,
                         hangtime_s=5.0, grant_grace_s=0.5,
                         cc_device_pick=True)
    B = int(FS)
    fleet.step(wide[:B])
    assert fleet.stats.grants == 1
    n_ev = len(fleet.cc_pipe.ctxs[0].events)
    fleet.step(wide[B:B + B // 2])
    assert len(fleet._ccbody_jits) == 2       # one program per length
    assert len(fleet.cc_pipe.ctxs[0].events) > n_ev
