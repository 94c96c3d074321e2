"""Fleet-scale CLOSED-LOOP trunking: control-channel grants rewrite
per-channel extraction rows between device steps — zero recompiles.

The reference follows ONE trunked call by retuning one tuner from its
controller thread (src/io/radio/rtl_sdr_fm.cpp:4665
controller_thread_retune_loop; scan rotation
src/engine/trunk_scan.c:1795).  The batched re-expression (SURVEY.md §2.8):
"retune = rewrite a channel's NCO/config row between steps".  One
wideband block per step runs

  1. a shared 2x-oversampled PFB over the whole band (dsp.channelizer),
  2. a ROW EXTRACTOR: R rows, each holding an integer-Hz offset from
     band center as *data* (a [R] int32 array input, never a static) —
     nearest PFB channel gather + exact integer-phase residual NCO +
     halfband → a 48 kHz baseband per row,
  3. the batched CC pipeline over the control rows (engine.ccbatch) and
     the batched voice pipeline over the voice rows,

and the host control plane walks the new CC events: a Group Voice
Channel Grant resolves channel→frequency through the per-CC iden table
and REWRITES a free voice row's offset for the next step.  Hangtime
expiry (no PCM energy on the row) parks the row again.  Because row
offsets are program *inputs*, grant → retarget → decode costs zero
recompilation — the whole trunked fleet is one compiled program per
block shape.

Unlike the reference (and unlike the serial LiveEngine+TrunkSM path,
which both follow ONE call at a time), every voice row is an
independent concurrent call slot: a fleet with V rows follows V
simultaneous grants across any number of monitored systems.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np

CHANNEL_RATE = 48000.0


# -- the row extractor -------------------------------------------------------
def make_row_extractor_body(n_ch: int, taps_per_branch: int = 16):
    """Traceable (wide [B] complex | [B, 2] float, offs_hz [R] int32) →
    [R, B'] complex64 48 kHz basebands — the un-jitted extractor body,
    reusable inside shard_map programs (parallel.mesh trunk step).

    Exact integer phase for the residual NCO: with fs2 = 96000 and
    res ∈ [-24000, 24000] Hz integer, phase(n)·fs2 = (a·((K·res) mod
    fs2) + b·(res mod fs2)) mod fs2 for n = a·K + b, K = 8192 — every
    product stays < 2^31, so the NCO phase is bit-exact over arbitrary
    block lengths (a float32 f·n/fs accumulates ~0.1-cycle error by
    n ≈ 10^6)."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.dsp import firdes, frontend
    from dsdneo_tpu.dsp.channelizer import channelize_os2

    hb = firdes.lowpass_taps(62, 2.0, 0.5,
                             window="blackman-harris").astype(np.float32)
    fs2 = 2 * int(CHANNEL_RATE)
    K = 8192
    # keep the PFB prototype ≥256 taps regardless of band width: at
    # small n_ch (narrow bands) n_ch·16 taps leaves only ~27 dB of
    # alias rejection at the ±2-spacing fold, which audibly degrades a
    # row when another carrier sits exactly 2 bins away
    taps_per_branch = max(taps_per_branch, 256 // n_ch)

    def run(wide, offs_hz):
        if wide.ndim == 2 and wide.dtype == jnp.uint8:
            # CU8 I/Q planes — the SDR wire format (librtlsdr delivers
            # offset-binary bytes).  Shipping raw bytes to the device
            # and converting there cuts the wideband upload 4x vs
            # float32 planes.
            wide = (wide.astype(jnp.float32) - 127.5) * (1.0 / 127.5)
        x = (jax.lax.complex(wide[..., 0], wide[..., 1])
             if wide.ndim == 2 else wide)
        # cutoff 0.75 spacings (±36 kHz): a row whose residual offset
        # approaches the ±24 kHz bin edge keeps its full occupied
        # bandwidth in the passband — the 2x-oversampled bin carries
        # ±48 kHz faithfully, and the post-mix halfband rejects
        # whatever the wider prototype lets through from neighbors
        ch2 = channelize_os2(x, n_ch, taps_per_branch,
                             cutoff=0.75)                  # [n_ch, B2] @96k
        # nearest PFB bin (centers at k·48k, FFT wrap) + integer residual
        kidx = jnp.round(offs_hz / CHANNEL_RATE).astype(jnp.int32)
        res = offs_hz - kidx * jnp.int32(CHANNEL_RATE)     # [-24k, 24k]
        rows = ch2[jnp.mod(kidx, n_ch)]                    # [R, B2]
        B2 = ch2.shape[1]
        n = jnp.arange(B2, dtype=jnp.int32)
        a, b = n // K, n % K
        r1 = jnp.mod(K * res, fs2)[:, None]                # [R, 1]
        rm = jnp.mod(res, fs2)[:, None]
        ph = jnp.mod(jnp.mod(a[None, :] * r1, fs2) + b[None, :] * rm, fs2)
        ang = (-2.0 * jnp.pi / fs2) * ph.astype(jnp.float32)
        mixed = rows * jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
        return frontend.decimate2_halfband(mixed, hb)      # [R, B'] @48k

    return run


def make_row_extractor(n_ch: int, taps_per_branch: int = 16):
    """Jitted row extractor (see :func:`make_row_extractor_body`)."""
    import jax
    return jax.jit(make_row_extractor_body(n_ch, taps_per_branch))


# -- control plane -----------------------------------------------------------
@dataclass
class VoiceCall:
    """One active call slot (a voice row following a grant)."""
    row: int                  # voice-row index (0-based within vc rows)
    tg: int
    src: int
    freq_hz: float            # absolute
    system: int               # CC row index that granted it
    granted_at: float
    last_voice: float
    pcm_samples: int = 0
    slot: int = 0             # TDMA slot (P25 Phase 2 rows)


@dataclass
class FleetStats:
    grants: int = 0
    grant_refreshes: int = 0
    releases: int = 0
    busy_drops: int = 0       # grants dropped: no free voice row
    policy_drops: int = 0
    unresolved: int = 0       # grants with no channel→freq resolution


class TrunkedFleet:
    """Closed-loop trunked fleet over one wideband stream.

    ``cc_offsets_hz``: control-channel offsets from band center (Hz,
    integer); ``n_voice_rows``: concurrent call slots.  ``step(wide)``
    consumes one wideband block ([B] complex or [B, 2] float planes)
    and returns the [V, T] float32 PCM of the voice rows.

    ``cc_device_pick=True`` (p25p1): replace the host TSDU candidate
    pick with the fixed-capacity device pick so the whole step needs
    ONE device-to-host exchange instead of three (control plane
    equivalent, see test_cc_device_pick_equivalent_control_plane).
    """

    def __init__(self, fs: float, cc_offsets_hz, n_voice_rows: int,
                 center_hz: float = 0.0, mode: str = "p25p1",
                 cqpsk: bool = False, hangtime_s: float = 1.0,
                 grant_grace_s: float = 1.5, sync_threshold: float = 0.62,
                 tg_policy=None, pcm_fmt: str = "f16", chan_map=None,
                 p2_rows: int = 0, p2_params=None,
                 cc_device_pick: bool = False):
        n_ch = int(round(fs / CHANNEL_RATE))
        if abs(fs - n_ch * CHANNEL_RATE) > 1.0 or n_ch < 2:
            raise ValueError(f"fs {fs:g} must be a ≥2 multiple of 48 kHz")
        if mode == "p25p1":
            from dsdneo_tpu.engine.ccbatch import BatchedP25ControlPipeline
            from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
            mk_cc = lambda n: BatchedP25ControlPipeline(
                n, fs=CHANNEL_RATE, cqpsk=cqpsk,
                sync_threshold=sync_threshold)
            mk_vc = lambda n: BatchedP25VoicePipeline(
                n, fs=CHANNEL_RATE, cqpsk=cqpsk,
                sync_threshold=sync_threshold, pcm_fmt=pcm_fmt)
        elif mode == "dmr":
            # DMR Tier III: CSBK grants carry an LPCN resolved through
            # the channel map (CSV import or C_BCAST chan/freq learning,
            # reference dmr_cspdu_pf0_c_bcast_maybe_store_channel)
            from dsdneo_tpu.engine.ccbatch import BatchedDmrControlPipeline
            from dsdneo_tpu.engine.dmrbatch import BatchedDmrVoicePipeline
            mk_cc = lambda n: BatchedDmrControlPipeline(
                n, fs=CHANNEL_RATE, sync_threshold=sync_threshold)
            mk_vc = lambda n: BatchedDmrVoicePipeline(
                n, fs=CHANNEL_RATE, sync_threshold=sync_threshold,
                pcm_fmt=pcm_fmt)
        elif mode in ("nxdn48", "nxdn96"):
            # NXDN Type-C trunking: VCALL_ASSGN on the RCCH carries a
            # 10-bit channel number resolved through the channel map
            from dsdneo_tpu.engine.ccbatch import BatchedNxdnControlPipeline
            from dsdneo_tpu.engine.nxdnbatch import BatchedNxdnVoicePipeline
            mk_cc = lambda n: BatchedNxdnControlPipeline(
                n, fs=CHANNEL_RATE, sync_threshold=min(sync_threshold, 0.55),
                mode=mode)
            mk_vc = lambda n: BatchedNxdnVoicePipeline(
                n, fs=CHANNEL_RATE, sync_threshold=min(sync_threshold, 0.55),
                pcm_fmt=pcm_fmt, mode=mode)
        elif mode == "p25p2":
            # Phase 2 TDMA control channel (reference
            # state->p25_cc_is_tdma=1, p25_trunk_sm.c:289: a 6000 sym/s
            # LCCH/SACCH MAC CC).  Every grant is a 2-slot TDMA voice
            # channel decoded by the batched P2 voice pipeline; with no
            # p2_params the CC's own scramble parameters are
            # blind-recovered from RS parity linearity.
            from dsdneo_tpu.engine.ccbatch import BatchedP2ControlPipeline
            w0, s0, n0 = p2_params if p2_params else (0, 0, 0)
            mk_cc = lambda n: BatchedP2ControlPipeline(
                n, fs=CHANNEL_RATE, wacn=w0, sysid=s0, nac=n0,
                sync_threshold=sync_threshold)
            mk_vc = None
            p2_rows = p2_rows or n_voice_rows
            n_voice_rows = 0
        elif mode == "edacs":
            # EDACS: BCH-screened CC messages grant an LCN; working
            # channels are analog NBFM (reference edacs.c analog voice
            # following) decoded by the batched analog pipeline
            from dsdneo_tpu.engine.analogbatch import (
                BatchedAnalogVoicePipeline)
            from dsdneo_tpu.engine.ccbatch import (
                BatchedEdacsControlPipeline)
            mk_cc = lambda n: BatchedEdacsControlPipeline(
                n, fs=CHANNEL_RATE, sync_threshold=sync_threshold)
            mk_vc = lambda n: BatchedAnalogVoicePipeline(
                n, fs=CHANNEL_RATE, pcm_fmt=pcm_fmt)
        else:
            raise ValueError("trunked fleet drives the p25p1, dmr, "
                             "nxdn48/96, or edacs CC+voice pipelines "
                             f"(got mode={mode!r})")
        if p2_rows and mode not in ("p25p1", "p25p2"):
            raise ValueError("Phase-2 voice rows ride a P25 control "
                             "channel (TDMA grants are flagged by the "
                             "iden table); use mode='p25p1'/'p25p2'")
        self.fs = fs
        self.mode = mode
        self.n_ch = n_ch
        self.center_hz = center_hz
        self.n_cc = len(cc_offsets_hz)
        self.n_vc = n_voice_rows
        self.n_vc2 = p2_rows
        self.hangtime_s = hangtime_s
        self.grant_grace_s = grant_grace_s
        self.tg_policy = tg_policy or (lambda tg: True)
        self.chan_map = chan_map
        self.pcm_fmt = pcm_fmt
        self.sync_threshold = sync_threshold
        # row offsets: CC rows, then P1 voice rows, then P2 voice rows,
        # idle voice rows parked on CC 0
        self.offs = np.zeros(self.n_cc + self.n_vc + self.n_vc2,
                             dtype=np.int32)
        self.offs[:self.n_cc] = np.asarray(cc_offsets_hz, dtype=np.int32)
        self.offs[self.n_cc:] = self.offs[0]
        self._extract = make_row_extractor(n_ch)
        self.cc_pipe = mk_cc(self.n_cc)
        self.vc_pipe = mk_vc(self.n_vc) if mk_vc is not None else None
        # the P2 pipeline needs the system's WACN/SYS/NAC scramble
        # parameters (reference p25p2 xCCH scrambler), which the CC
        # broadcasts (NET_STS + NID); construct lazily on first TDMA
        # grant unless pinned via p2_params
        self.vc2_pipe = None
        self._p2_params = p2_params
        if chan_map is not None:
            for ctx in self.cc_pipe.ctxs:
                ctx.state.chan_map = chan_map
        self.calls: dict[int, VoiceCall] = {}       # P1 row -> call
        self.calls2: dict[tuple, VoiceCall] = {}    # (P2 row, slot)
        self.p2_pcm = np.zeros((2 * self.n_vc2, 0), dtype=np.float32)
        self._free = list(range(self.n_vc))
        self._free2 = list(range(self.n_vc2))
        self._ev_cursor = [0] * self.n_cc
        self.clock = 0.0
        self.blocks = 0
        self.stats = FleetStats()
        self.log: list[str] = []
        self._next_block = None        # double-buffer upload handle
        # cc_device_pick (p25p1 only): replace the host candidate pick
        # with the fixed-capacity DEVICE pick (parallel.mesh
        # _p25_cc_body, shoulder-suppressed) so the step needs ONE
        # device-to-host exchange instead of three
        self.cc_device_pick = bool(cc_device_pick and mode == "p25p1"
                                   and not cqpsk)
        self._ccbody_jits: dict[int, object] = {}   # keyed by rows' B
        self._cc_k = 16                # TSDU capacity per block

    # -- grant handling -----------------------------------------------------
    def _resolve_freq(self, cc: int, fields: dict) -> float:
        ch = int(fields.get("channel", 0) or 0)
        if ch not in (0, 0xFFFF):
            it = getattr(self.cc_pipe.ctxs[cc].state, "iden_table", None)
            if it is not None:
                f = it.channel_to_freq(ch)
                if f:
                    return float(f)
            if self.chan_map is not None:
                f = self.chan_map.freq(ch)
                if f:
                    return float(f)
        # DMR Tier III grants carry an LPCN instead of a P25 iden
        # channel: resolve through the channel map (CSV / C_BCAST)
        lpcn = int(fields.get("lpcn", 0) or 0)
        if lpcn not in (0, 0xFFF) and self.chan_map is not None:
            f = self.chan_map.freq(lpcn)
            if f:
                return float(f)
        return 0.0

    def _grant_slots(self, cc: int, fields: dict) -> int:
        """TDMA slot count of the granted channel's iden (1 = FDMA/P1,
        2 = Phase 2; reference p25_frequency.c iden_up TDMA types)."""
        ch = int(fields.get("channel", 0) or 0)
        it = getattr(self.cc_pipe.ctxs[cc].state, "iden_table", None)
        if self.mode == "p25p2":
            # a TDMA CC defaults to 2-slot grants, but a mixed system
            # can broadcast FDMA grants on it (reference
            # p25_frequency.c p25_select_iden_entry falls back to the
            # FDMA iden entry) — consult the iden table so those are
            # not misrouted into the 2-slot TDMA voice pipeline
            if ch in (0, 0xFFFF) or it is None:
                return 2
            ent = it.entries.get((ch >> 12) & 0xF)
            return ent[3] if ent else 2
        if ch in (0, 0xFFFF) or it is None:
            return 1
        ent = it.entries.get((ch >> 12) & 0xF)
        return ent[3] if ent else 1

    def _ensure_p2_pipe(self, cc: int) -> bool:
        if self.vc2_pipe is not None:
            return True
        if self._p2_params is not None:
            wacn, sysid, nac = self._p2_params
        else:
            s = self.cc_pipe.ctxs[cc].state
            wacn, sysid = s.p2_wacn, s.p2_sysid
            nac = s.nac or getattr(s, "p2_cc", 0)
        if not (wacn and sysid and nac):
            return False        # identity not yet broadcast on this CC
        from dsdneo_tpu.engine.p2batch import BatchedP2VoicePipeline
        self.vc2_pipe = BatchedP2VoicePipeline(
            self.n_vc2, fs=CHANNEL_RATE, wacn=wacn, sysid=sysid, nac=nac,
            sync_threshold=self.sync_threshold, pcm_fmt=self.pcm_fmt)
        self.log.append(f"[{self.clock:7.2f}s] P2 pipeline up: WACN "
                        f"{wacn:05X} SYS {sysid:03X} NAC {nac:03X}")
        return True

    def _on_grant_p2(self, cc: int, fields: dict, tg: int, freq: float,
                     off: int) -> None:
        """TDMA grant → a Phase-2 row follows (freq, slot).  Two slots
        of one frequency share one extraction row (the reference tunes
        one tuner to the P2 VC and decodes both timeslots;
        p25p2_frame.c) — a second grant on the other slot of an active
        row attaches to it instead of consuming a new row."""
        slot = 0
        ch = int(fields.get("channel", 0) or 0)
        it = getattr(self.cc_pipe.ctxs[cc].state, "iden_table", None)
        if it is not None:
            slot = it.channel_to_slot(ch)
        for (row, sl), call in self.calls2.items():
            if int(round(call.freq_hz - self.center_hz)) != off:
                continue
            if sl == slot:
                call.last_voice = self.clock
                self.stats.grant_refreshes += 1
                return
            if (row, slot) in self.calls2:
                continue        # our slot's call rides another entry
            # other slot active on the same VC: share its row
            self.calls2[(row, slot)] = VoiceCall(
                row=row, tg=tg, src=int(fields.get("src", 0) or 0),
                freq_hz=freq, system=cc, granted_at=self.clock,
                last_voice=self.clock, slot=slot)
            self.stats.grants += 1
            self.log.append(f"[{self.clock:7.2f}s] GRANT TG {tg} -> "
                            f"p2 row {row} slot {slot} @ "
                            f"{freq / 1e6:.4f} MHz (sys {cc})")
            return
        if not self.tg_policy(tg):
            self.stats.policy_drops += 1
            return
        if not self._free2 or not self._ensure_p2_pipe(cc):
            self.stats.busy_drops += 1
            return
        row = self._free2.pop(0)
        self.offs[self.n_cc + self.n_vc + row] = off
        self.vc2_pipe.reset_voice_state([2 * row, 2 * row + 1])
        for s in (2 * row, 2 * row + 1):
            self.vc2_pipe.crypto[s] = {"alg": 0, "kid": 0, "mi": 0,
                                       "staged": None}
        self.calls2[(row, slot)] = VoiceCall(
            row=row, tg=tg, src=int(fields.get("src", 0) or 0),
            freq_hz=freq, system=cc, granted_at=self.clock,
            last_voice=self.clock, slot=slot)
        self.stats.grants += 1
        self.log.append(f"[{self.clock:7.2f}s] GRANT TG {tg} -> p2 row "
                        f"{row} slot {slot} @ {freq / 1e6:.4f} MHz "
                        f"(sys {cc})")

    def _on_grant(self, cc: int, fields: dict) -> None:
        tg = int(fields.get("tg", 0) or 0)
        freq = self._resolve_freq(cc, fields)
        if freq <= 0:
            self.stats.unresolved += 1
            return
        off = int(round(freq - self.center_hz))
        if abs(off) > self.fs / 2 - CHANNEL_RATE / 2:
            self.stats.unresolved += 1
            return
        if self.n_vc2 and self._grant_slots(cc, fields) >= 2:
            self._on_grant_p2(cc, fields, tg, freq, off)
            return
        if self.mode == "p25p2":
            # FDMA grant on a TDMA CC with no FDMA voice rows: there is
            # no pipeline that can decode it — count it unresolved
            # rather than feeding an FDMA carrier to the 2-slot P2 path
            self.stats.unresolved += 1
            return
        # grant repeat for an active call = activity (refresh hangtime)
        for call in self.calls.values():
            if int(round(call.freq_hz - self.center_hz)) == off:
                call.last_voice = self.clock
                self.stats.grant_refreshes += 1
                return
        if not self.tg_policy(tg):
            self.stats.policy_drops += 1
            return
        if not self._free:
            self.stats.busy_drops += 1
            return
        row = self._free.pop(0)
        self.offs[self.n_cc + row] = off
        # retargeted row: drop the previous call's synthesis/repeat
        # carry before the next device step decodes the new stream
        self.vc_pipe.reset_voice_state([row])
        self.calls[row] = VoiceCall(
            row=row, tg=tg, src=int(fields.get("src", 0) or 0),
            freq_hz=freq, system=cc, granted_at=self.clock,
            last_voice=self.clock)
        self.stats.grants += 1
        self.log.append(f"[{self.clock:7.2f}s] GRANT TG {tg} -> row {row}"
                        f" @ {freq / 1e6:.4f} MHz (sys {cc})")

    def _walk_cc_events(self) -> None:
        for cc in range(self.n_cc):
            evs = self.cc_pipe.ctxs[cc].events
            for ev in evs[self._ev_cursor[cc]:]:
                if ev.fields.get("grant"):
                    self._on_grant(cc, ev.fields)
            self._ev_cursor[cc] = len(evs)

    def _tick_releases(self) -> None:
        for row, call in list(self.calls.items()):
            idle = self.clock - call.last_voice
            age = self.clock - call.granted_at
            if idle > self.hangtime_s and age > self.grant_grace_s:
                self.log.append(f"[{self.clock:7.2f}s] RELEASE TG "
                                f"{call.tg} row {row} "
                                f"({call.pcm_samples} samples)")
                del self.calls[row]
                self._free.append(row)
                self.offs[self.n_cc + row] = self.offs[0]   # park on CC 0
                self.stats.releases += 1
        for key, call in list(self.calls2.items()):
            idle = self.clock - call.last_voice
            age = self.clock - call.granted_at
            if idle > self.hangtime_s and age > self.grant_grace_s:
                row, slot = key
                self.log.append(f"[{self.clock:7.2f}s] RELEASE TG "
                                f"{call.tg} p2 row {row} slot {slot} "
                                f"({call.pcm_samples} samples)")
                del self.calls2[key]
                self.stats.releases += 1
                # park the row only once BOTH slots are done
                if not any(r == row for r, _ in self.calls2):
                    self._free2.append(row)
                    self.offs[self.n_cc + self.n_vc + row] = self.offs[0]

    # -- the step -------------------------------------------------------------
    def prefetch(self, wide: np.ndarray):
        """Start the async host→device upload of a wideband block and
        return a device handle that :meth:`step` accepts in place of a
        host array.  Double-buffering — uploading block N+1 while block
        N's device programs run — hides the transfer under compute,
        exactly as the reference's dongle
        thread fills the next ring buffer while the demod thread
        consumes the current one (src/io/radio/rtl_sdr_fm.cpp USB
        callback + ring)."""
        import jax
        if isinstance(wide, np.ndarray):
            if np.iscomplexobj(wide):           # never upload complex
                wide = np.stack([wide.real, wide.imag],
                                axis=-1).astype(np.float32)
            wide = jax.device_put(wide)
        return wide

    def step(self, wide: np.ndarray, prefetch=None) -> np.ndarray:
        """One wideband block → [n_voice_rows, T] float32 PCM.  CC
        grants observed in this block retarget rows for the NEXT block
        (the reference's controller thread likewise retunes between
        demod iterations).

        ``wide=None`` consumes the block most recently queued via
        ``prefetch=``; passing the NEXT host block as ``prefetch=``
        enqueues its upload right after this block's device programs
        dispatch, so the transfer rides under their execution."""
        import jax
        import jax.numpy as jnp
        if wide is None:
            wide = self._next_block
            self._next_block = None
            if wide is None:
                raise ValueError("step(None) without a prefetched block")
        elif self._next_block is not None:
            # a fresh block supersedes a queued prefetch: keeping the
            # stale handle would hand a later step(None) an out-of-order
            # block silently
            self.log.append(f"[{self.clock:7.2f}s] WARN: prefetched "
                            "block dropped (step called with a fresh "
                            "block while one was queued)")
            self._next_block = None
        if isinstance(wide, np.ndarray):
            # ship float planes; the extractor forms complex on device
            if np.iscomplexobj(wide):
                wide = np.stack([wide.real, wide.imag],
                                axis=-1).astype(np.float32)
            wide = jnp.asarray(wide)
        rows = self._extract(wide, jnp.asarray(self.offs))
        block_s = float(rows.shape[1]) / CHANNEL_RATE
        # split under jit into [R, B', 2] float planes, the pipelines'
        # wire format (one program instead of three eager slices)
        if not hasattr(self, "_split"):
            n_cc, n_v1 = self.n_cc, self.n_vc
            planes = lambda r: jnp.stack([r.real, r.imag], axis=-1)
            self._split = jax.jit(lambda r: (
                planes(r[:n_cc]), planes(r[n_cc:n_cc + n_v1]),
                planes(r[n_cc + n_v1:])))
        cc_rows, vc_rows, vc2_rows = self._split(rows)
        # Overlap the control and voice planes: enqueue the CC
        # candidate program, then the voice programs (the device runs
        # them in submission order), and do the CC blob fetch + host
        # pick + catalog parse WHILE the voice programs execute — the
        # reference's controller thread similarly overlaps tuner
        # retune/parse with the demod thread (rtl_sdr_fm.cpp:4665).
        pcm = h = h2 = None
        cc_fe = cc_out = None
        if self.cc_device_pick:
            # the body's shapes are statics: a partial final block
            # (shorter B) gets its own program
            nb = int(cc_rows.shape[1])
            body = self._ccbody_jits.get(nb)
            if body is None:
                from dsdneo_tpu.parallel.mesh import _p25_cc_body
                body = self._ccbody_jits[nb] = jax.jit(_p25_cc_body(
                    self.n_cc, nb, CHANNEL_RATE, self._cc_k,
                    self.sync_threshold, nac_out=True, dedup=True))
            cc_out = body(cc_rows)               # (blob, valid, msg)
        else:
            cc_fe = self.cc_pipe.frontend_dispatch(cc_rows)
        if self.calls:
            if hasattr(self.vc_pipe, "decode_block_async"):
                h = self.vc_pipe.decode_block_async(vc_rows)
            else:                         # analog pipeline: sync only
                pcm = self.vc_pipe.decode_block(vc_rows)
        if self.calls2:
            h2 = self.vc2_pipe.decode_block_async(vc2_rows)
        if prefetch is not None:
            # every device program for THIS block is now enqueued; the
            # next block's upload streams while they execute
            self._next_block = self.prefetch(prefetch)
        # co-fetch the voice wire(s) in the SAME device-to-host
        # exchange as the CC TSDU blob where the pipeline supports it
        cof = tuple(x for x in (h, h2) if x is not None)
        if cc_out is not None:
            # device-pick CC: the whole step is ONE d2h exchange
            fetched = jax.device_get((cc_out,) + cof)
            blob, valid, msg = fetched[0]
            self._cc_events_from_blob(blob, valid, msg)
            rest = list(fetched[1:])
            if h is not None:
                h = rest.pop(0)
            if h2 is not None:
                h2 = rest.pop(0)
        elif cof and self.mode == "p25p1":
            _n, co_np = self.cc_pipe.events_from_frontend(
                self.cc_pipe.frontend_finish(cc_fe), cofetch=cof)
            co = list(co_np)
            if h is not None:
                h = co.pop(0)
            if h2 is not None:
                h2 = co.pop(0)
        else:
            self.cc_pipe.events_from_frontend(
                self.cc_pipe.frontend_finish(cc_fe))
        if h is not None:
            pcm = self.vc_pipe.fetch_pcm(h)
        if pcm is not None:
            # rows without an active call are parked on the CC: their
            # decode output is not audio (the reference's tuner is
            # muted between calls) — matters for analog rows, where a
            # parked row would otherwise "decode" the CC's FSK as growl
            if pcm.shape[1]:
                mask = np.zeros((self.n_vc, 1), dtype=pcm.dtype)
                for row in self.calls:
                    mask[row] = 1.0
                pcm = pcm * mask
        else:
            pcm = np.zeros((self.n_vc, 0), dtype=np.float32)
        if h2 is not None:
            pcm2 = self.vc2_pipe.fetch_pcm(h2)           # [2·V2, T2]
            if pcm2.shape[1]:
                mask2 = np.zeros((2 * self.n_vc2, 1), dtype=pcm2.dtype)
                for (row, slot) in self.calls2:
                    mask2[2 * row + slot] = 1.0
                pcm2 = pcm2 * mask2
        else:
            pcm2 = np.zeros((2 * self.n_vc2, 0), dtype=np.float32)
        self.p2_pcm = pcm2
        # voice activity per active row: PCM energy refreshes hangtime
        if pcm.shape[1]:
            energy = np.abs(pcm).mean(axis=1)
            for row, call in self.calls.items():
                if energy[row] > 1e-4:
                    call.last_voice = self.clock + block_s
                    call.pcm_samples += int(pcm.shape[1])
        if pcm2.shape[1]:
            energy2 = np.abs(pcm2).mean(axis=1)
            for (row, slot), call in self.calls2.items():
                if energy2[2 * row + slot] > 1e-4:
                    call.last_voice = self.clock + block_s
                    call.pcm_samples += int(pcm2.shape[1])
        self.clock += block_s
        self.blocks += 1
        self._walk_cc_events()
        self._tick_releases()
        return pcm

    def _cc_events_from_blob(self, blob, valid, msg) -> int:
        """Host catalog parse of device-picked TSDU blobs
        ([n_cc, K, 114]; parallel.mesh._p25_cc_body layout, same walk
        as ShardedTrunkedFleet._parse_blobs)."""
        from dsdneo_tpu.engine.ccbatch import TSDU_BLOCKS
        n = 0
        for c in range(self.n_cc):
            ctx = self.cc_pipe.ctxs[c]
            for k in range(blob.shape[1]):
                if not valid[c, k]:
                    continue
                pos = self.blocks * 100 + k
                nac = (int(msg[c, k]) >> 4) & 0xFFF
                if nac not in (0, 0xFFF):
                    ctx.state.nac = nac
                    ctx.state.p2_cc = nac
                blk = blob[c, k].reshape(TSDU_BLOCKS, 38)
                for b in range(TSDU_BLOCKS):
                    if blk[b, 12]:
                        data = blk[b, :12]
                    else:
                        data = self.cc_pipe._crc_fallback(blk[b, 13:38])
                        if data is None:
                            break
                    n += 1
                    if self.cc_pipe._parse_tsbk(c, pos, data):
                        break
        return n

    # -- one-block-deep pipelined step ---------------------------------------
    def step_pipelined(self, wide, prefetch=None) -> np.ndarray:
        """Deep-pipelined form of :meth:`step`: dispatches THIS block's
        device programs, then consumes the PREVIOUS block's results
        (CC blob fetch + catalog parse + voice PCM) while this block
        executes on device — the two device-to-host exchanges and the
        host parse ride under the current block's compute instead of
        serializing behind it.

        Returns the PREVIOUS block's [n_voice_rows, T] PCM (empty on
        the first call).  The cost is one extra block of control-plane
        latency: a grant observed in block N retargets rows for block
        N+2 instead of N+1 — the same tolerance the reference's
        asynchronous controller-thread retune already has
        (src/io/radio/rtl_sdr_fm.cpp:4665).  P1 voice rows only (the
        P2 row path stays on the synchronous step), and the CC always
        uses the host pick here (``cc_device_pick`` applies to
        :meth:`step`)."""
        import jax
        import jax.numpy as jnp
        if self.n_vc2:
            raise ValueError("step_pipelined drives P1 voice rows only")
        if wide is None:
            wide = self._next_block
            self._next_block = None
            if wide is None:
                raise ValueError("step(None) without a prefetched block")
        elif self._next_block is not None:
            self.log.append(f"[{self.clock:7.2f}s] WARN: prefetched "
                            "block dropped (step called with a fresh "
                            "block while one was queued)")
            self._next_block = None
        if isinstance(wide, np.ndarray):
            if np.iscomplexobj(wide):
                wide = np.stack([wide.real, wide.imag],
                                axis=-1).astype(np.float32)
            wide = jnp.asarray(wide)
        rows = self._extract(wide, jnp.asarray(self.offs))
        block_s = float(rows.shape[1]) / CHANNEL_RATE
        if not hasattr(self, "_split"):
            n_cc, n_v1 = self.n_cc, self.n_vc
            planes = lambda r: jnp.stack([r.real, r.imag], axis=-1)
            self._split = jax.jit(lambda r: (
                planes(r[:n_cc]), planes(r[n_cc:n_cc + n_v1]),
                planes(r[n_cc + n_v1:])))
        cc_rows, vc_rows, _vc2 = self._split(rows)
        cc_fe = self.cc_pipe.frontend_dispatch(cc_rows)
        h = (self.vc_pipe.decode_block_async(vc_rows)
             if self.calls else None)
        if prefetch is not None:
            self._next_block = self.prefetch(prefetch)
        # snapshot the call set the dispatched block decodes under
        cur = (cc_fe, h, dict(self.calls), block_s)
        pend = getattr(self, "_pipe_pending", None)
        self._pipe_pending = cur
        if pend is None:
            return np.zeros((self.n_vc, 0), dtype=np.float32)
        # consume the previous block while this one executes on device
        return self._consume_pending(pend)

    def flush_pipelined(self) -> np.ndarray:
        """Consume the last in-flight block of :meth:`step_pipelined`
        (end of stream): returns its PCM."""
        pend = getattr(self, "_pipe_pending", None)
        if pend is None:
            return np.zeros((self.n_vc, 0), dtype=np.float32)
        self._pipe_pending = None
        return self._consume_pending(pend)

    def _consume_pending(self, pend) -> np.ndarray:
        p_fe, p_h, p_calls, p_block_s = pend
        if p_h is not None and self.mode == "p25p1":
            # single d2h exchange for TSDU blob + voice wire (see step)
            _n, co = self.cc_pipe.events_from_frontend(
                self.cc_pipe.frontend_finish(p_fe), cofetch=(p_h,))
            pcm = self.vc_pipe.fetch_pcm(co[0])
        else:
            self.cc_pipe.events_from_frontend(
                self.cc_pipe.frontend_finish(p_fe))
            if p_h is not None:
                pcm = self.vc_pipe.fetch_pcm(p_h)
            else:
                pcm = np.zeros((self.n_vc, 0), dtype=np.float32)
        if pcm.shape[1]:
            mask = np.zeros((self.n_vc, 1), dtype=pcm.dtype)
            for row in p_calls:
                mask[row] = 1.0
            pcm = pcm * mask
            energy = np.abs(pcm).mean(axis=1)
            for row in p_calls:
                if energy[row] > 1e-4 and row in self.calls:
                    self.calls[row].last_voice = self.clock + p_block_s
                    self.calls[row].pcm_samples += int(pcm.shape[1])
        self.clock += p_block_s
        self.blocks += 1
        self._walk_cc_events()
        self._tick_releases()
        return pcm

    # -- introspection --------------------------------------------------------
    def row_dicts(self) -> list[dict]:
        """Channel-grid rows (ui.panes style): CC rows then voice rows."""
        out = []
        for i in range(self.n_cc):
            out.append({"id": i, "freq_hz": float(self.offs[i]),
                        "state": "cc", "tg": 0})
        for v in range(self.n_vc):
            call = self.calls.get(v)
            out.append({
                "id": self.n_cc + v,
                "freq_hz": float(self.offs[self.n_cc + v]),
                "state": f"voice TG {call.tg}" if call else "idle",
                "tg": call.tg if call else 0})
        for v in range(self.n_vc2):
            slots = {s: c for (r, s), c in self.calls2.items() if r == v}
            state = " ".join(f"s{s} TG {c.tg}"
                             for s, c in sorted(slots.items()))
            out.append({
                "id": self.n_cc + self.n_vc + v,
                "freq_hz": float(self.offs[self.n_cc + self.n_vc + v]),
                "state": f"p2 {state}" if slots else "idle",
                "tg": next(iter(slots.values())).tg if slots else 0})
        return out
