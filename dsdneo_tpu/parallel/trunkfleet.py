"""Closed-loop trunking over the device MESH: S trunked systems, one
wideband stream each, sharded across chips — grants rewrite voice-row
offsets between SPMD steps with zero recompiles.

This composes the two flagship stories:

- engine.fleettrunk.TrunkedFleet — the single-chip closed trunking
  loop (the reference's controller-thread retune,
  src/io/radio/rtl_sdr_fm.cpp:4665, re-expressed per SURVEY §2.8 as
  "retune = rewrite a channel's NCO/config row between steps"), and
- parallel.mesh — the channel-sharded SPMD family programs,

into one program: ``make_sharded_trunk_step`` runs every system's row
extraction + CC TSDU decode + P25p1 voice chain under ``shard_map``,
and ``ShardedTrunkedFleet`` keeps a host control plane per system that
parses the returned TSDU blobs, resolves Group Voice Channel Grants
through each system's iden table, and rewrites that system's voice-row
offsets (a sharded [S, R] int32 DATA input) for the next step.  The
reference needs one controller thread per tuner per system; here a
whole fleet of systems is one compiled program per block shape, scaled
by adding chips to the mesh.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu.engine.fleettrunk import (CHANNEL_RATE, FleetStats,
                                          VoiceCall)
from dsdneo_tpu.parallel.mesh import make_sharded_trunk_step


class ShardedTrunkedFleet:
    """S trunked systems over a device mesh, one CC + ``n_vc``
    concurrent voice rows each.  ``mode`` picks the family chain:
    "p25p1" (TSBK/LDU), "dmr" (Tier III CSBK/AMBE), "nxdn48"/"nxdn96"
    (Type-C CAC/AMBE), "edacs" (BCH CC/analog NBFM), or "p25_mixed"
    (P1 TSBK CC granting TDMA channels into the Phase-2 voice body —
    PCM is [S, 2·n_vc, T] per-slot rows; needs
    ``p2_params=(wacn, sysid, nac)``).

    ``cc_offsets_hz[s]``: the system's control-channel offset from its
    band center (integer Hz); ``centers_hz[s]``: absolute band center
    (scalar broadcast allowed).  ``step(wide)`` consumes one [S, B]
    wideband block (complex, or [S, B, 2] float I/Q planes) and returns
    [S, n_vc, T] float32 PCM of the voice rows.

    Grants observed in block N retarget rows for block N+1, exactly
    like the single-system TrunkedFleet (the reference's controller
    thread likewise retunes between demod iterations).  The sharded
    voice body starts each step from fresh synthesis state, so a
    retargeted row needs no device-side carry reset.
    """

    def __init__(self, mesh, n_systems: int, fs: float, B: int,
                 cc_offsets_hz, n_voice_rows: int, centers_hz=0.0,
                 mode: str = "p25p1", hangtime_s: float = 1.0,
                 grant_grace_s: float = 1.5,
                 sync_threshold: float = 0.62, tg_policy=None,
                 chan_map=None, max_tsdus: int = 4, max_ldus: int = 2,
                 p2_params=None, edacs_ea: bool = False,
                 esk_mask: int = 0):
        from dsdneo_tpu.engine.ccbatch import (
            BatchedDmrControlPipeline, BatchedEdacsControlPipeline,
            BatchedNxdnControlPipeline, BatchedP25ControlPipeline)
        self.S = n_systems
        self.fs = fs
        self.B = B
        self.mode = mode
        self.n_vc = n_voice_rows
        self.hangtime_s = hangtime_s
        self.grant_grace_s = grant_grace_s
        self.tg_policy = tg_policy or (lambda tg: True)
        self.chan_map = chan_map
        centers = np.broadcast_to(np.asarray(centers_hz, np.float64),
                                  (n_systems,))
        self.centers = centers.copy()
        self.offs = np.zeros((n_systems, 1 + n_voice_rows), np.int32)
        self.offs[:, 0] = np.asarray(cc_offsets_hz, np.int32)
        self.offs[:, 1:] = self.offs[:, :1]       # park voice on the CC
        self.step_fn, (self._w_shard, self._o_shard) = \
            make_sharded_trunk_step(mesh, n_systems, fs, B, n_cc=1,
                                    n_vc=n_voice_rows,
                                    max_tsdus=max_tsdus,
                                    max_ldus=max_ldus,
                                    sync_threshold=sync_threshold,
                                    trunk_mode=mode,
                                    p2_params=p2_params)
        # host halves only (catalog parse, parse cache, iden tables);
        # ctx s belongs to system s's control channel
        if mode in ("p25p1", "p25_mixed"):
            self._cc_host = BatchedP25ControlPipeline(n_systems,
                                                      fs=CHANNEL_RATE)
        elif mode == "dmr":
            self._cc_host = BatchedDmrControlPipeline(n_systems,
                                                      fs=CHANNEL_RATE)
        elif mode in ("nxdn48", "nxdn96"):
            self._cc_host = BatchedNxdnControlPipeline(n_systems,
                                                       fs=CHANNEL_RATE,
                                                       mode=mode)
        elif mode == "edacs":
            self._cc_host = BatchedEdacsControlPipeline(
                n_systems, fs=CHANNEL_RATE, ea_mode=edacs_ea,
                esk_mask=esk_mask)
        else:
            raise ValueError("ShardedTrunkedFleet drives the p25p1, "
                             "dmr, nxdn48/96, edacs, or p25_mixed "
                             f"CC+voice bodies (got mode={mode!r})")
        if chan_map is not None:
            for ctx in self._cc_host.ctxs:
                ctx.state.chan_map = chan_map
        self.calls: list[dict[int, VoiceCall]] = [
            dict() for _ in range(n_systems)]
        # p25_mixed: TDMA calls keyed (row, slot); two slots of one
        # granted frequency share one extraction row (the reference
        # tunes one tuner to the P2 VC and decodes both timeslots)
        self.calls2: list[dict[tuple, VoiceCall]] = [
            dict() for _ in range(n_systems)]
        self._free: list[list[int]] = [list(range(n_voice_rows))
                                       for _ in range(n_systems)]
        self._ev_cursor = [0] * n_systems
        self.clock = 0.0
        self.blocks = 0
        self.stats = FleetStats()
        self.log: list[str] = []
        self._next_block = None        # double-buffer upload handle

    # -- host control plane ---------------------------------------------------
    def _parse_blobs(self, blob: np.ndarray, valid: np.ndarray,
                     meta: np.ndarray) -> int:
        """Walk the [S, 1, K, W] CC blobs through each system's catalog
        parser.  P25 (and p25_mixed): W=114 TSDU blobs
        (mesh._p25_cc_body layout, 3 × (12 payload B, 1 crc-ok B, 25
        raw-dibit B)), meta = NID msg16.  DMR: W=14 CSBK blobs (12
        payload B + crc-ok + BPTC errs), meta = slot-type color code.
        NXDN: W=23 CAC blobs (22 packed payload B + crc-ok), meta =
        LICH.  EDACS: W=12 (msg1 4B + msg2 4B + ok + inv + pad), meta
        = polarity."""
        from dsdneo_tpu.engine.ccbatch import TSDU_BLOCKS
        n_parsed = 0
        for s in range(self.S):
            ctx = self._cc_host.ctxs[s]
            for k in range(blob.shape[2]):
                if not valid[s, 0, k]:
                    continue
                pos = self.blocks * 100 + k
                if self.mode == "dmr":
                    if blob[s, 0, k, 12]:
                        self._cc_host._parse_csbk(
                            s, pos, int(meta[s, 0, k]) & 0xF,
                            blob[s, 0, k, :12])
                        n_parsed += 1
                    continue
                if self.mode in ("nxdn48", "nxdn96"):
                    n_parsed += self._parse_cac(s, pos, blob[s, 0, k])
                    continue
                if self.mode == "edacs":
                    n_parsed += self._parse_edacs(s, pos, blob[s, 0, k])
                    continue
                nac = (int(meta[s, 0, k]) >> 4) & 0xFFF
                if nac not in (0, 0xFFF):
                    ctx.state.nac = nac
                    ctx.state.p2_cc = nac
                blk = blob[s, 0, k].reshape(TSDU_BLOCKS, 38)
                for b in range(TSDU_BLOCKS):
                    if blk[b, 12]:
                        data = blk[b, :12]
                    else:
                        data = self._cc_host._crc_fallback(blk[b, 13:38])
                        if data is None:
                            break
                    n_parsed += 1
                    if self._cc_host._parse_tsbk(s, pos, data):
                        break
        return n_parsed

    def _parse_cac(self, s: int, pos: int, row: np.ndarray) -> int:
        """One NXDN CAC blob row through the host catalog
        (BatchedNxdnControlPipeline.events_from_frontend's parse)."""
        ctx = self._cc_host.ctxs[s]
        if not row[22]:
            self._cc_host.crc_errors += 1
            ctx.emit(" CAC CRC ERR", "nxdn", pos)
            return 0
        dec = np.unpackbits(row[:22])[:171]
        ran = 0
        for b in dec[2:8]:
            ran = (ran << 1) | int(b)
        ctx.state.nxdn_ran = ran
        detail = self._cc_host.decs[s]._message(dec[8:155], ctx)
        ctx.emit(f"Sync: NXDN CC  RCCH CAC RAN {ran:02d}{detail}",
                 "nxdn", pos, ran=ran)
        return 1

    def _parse_edacs(self, s: int, pos: int, row: np.ndarray) -> int:
        """One EDACS blob row (msg pair) through the standard/EA
        catalog (BatchedEdacsControlPipeline.events_from_frontend's
        parse)."""
        from dsdneo_tpu.engine.ccbatch import _sync_kernel
        from dsdneo_tpu.symbols import framesync
        ctx = self._cc_host.ctxs[s]
        if not row[8]:
            self._cc_host.bch_errors += 1
            ctx.emit("Sync: +EDACS  BCH FAIL", "edacs", pos)
            return 0
        v1 = int(row[0:4].copy().view(np.uint32)[0])
        v2 = int(row[4:8].copy().view(np.uint32)[0])
        esk = int(getattr(ctx.state, "edacs_esk", 0) or 0)
        if esk:
            v1 ^= (esk & 0xFF) << 20
            v2 ^= (esk & 0xFF) << 20
        dec = self._cc_host.decs[s]
        hit = framesync.SyncHit(
            pos=pos, score=1.0,
            sync=_sync_kernel(self._cc_host.SYNC_NAMES)[0][0])
        if getattr(ctx.state, "edacs_ea", False):
            line = dec._extended(v1, v2, ctx, hit)
        else:
            line = dec._standard(v1, v2, ctx, hit)
        pol = "-" if row[9] else "+"
        ctx.emit(f"Sync: {pol}EDACS {line}", "edacs", pos,
                 mt=v1 >> 23, word=v1)
        return 1

    def _resolve_freq(self, s: int, fields: dict) -> float:
        ch = int(fields.get("channel", 0) or 0)
        if ch not in (0, 0xFFFF):
            it = getattr(self._cc_host.ctxs[s].state, "iden_table", None)
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

    def _on_grant(self, s: int, fields: dict) -> None:
        tg = int(fields.get("tg", 0) or 0)
        freq = self._resolve_freq(s, fields)
        if freq <= 0:
            self.stats.unresolved += 1
            return
        off = int(round(freq - self.centers[s]))
        if abs(off) > self.fs / 2 - CHANNEL_RATE / 2:
            self.stats.unresolved += 1
            return
        if self.mode == "p25_mixed":
            self._on_grant_p2(s, fields, tg, freq, off)
            return
        for call in self.calls[s].values():
            if int(round(call.freq_hz - self.centers[s])) == off:
                call.last_voice = self.clock
                self.stats.grant_refreshes += 1
                return
        if not self.tg_policy(tg):
            self.stats.policy_drops += 1
            return
        if not self._free[s]:
            self.stats.busy_drops += 1
            return
        row = self._free[s].pop(0)
        self.offs[s, 1 + row] = off
        self.calls[s][row] = VoiceCall(
            row=row, tg=tg, src=int(fields.get("src", 0) or 0),
            freq_hz=freq, system=s, granted_at=self.clock,
            last_voice=self.clock)
        self.stats.grants += 1
        self.log.append(f"[{self.clock:7.2f}s] sys {s} GRANT TG {tg} "
                        f"-> row {row} @ {freq / 1e6:.4f} MHz")

    def _on_grant_p2(self, s: int, fields: dict, tg: int, freq: float,
                     off: int) -> None:
        """p25_mixed TDMA grant → (row, slot) call; the other slot of
        an already-granted frequency shares its extraction row
        (engine.fleettrunk.TrunkedFleet._on_grant_p2)."""
        ch = int(fields.get("channel", 0) or 0)
        it = getattr(self._cc_host.ctxs[s].state, "iden_table", None)
        if it is not None:
            ent = it.entries.get((ch >> 12) & 0xF)
            if ent and ent[3] < 2:
                # FDMA grant on the mixed CC: the sharded fleet's voice
                # rows are all Phase 2 — unresolvable here
                self.stats.unresolved += 1
                return
        slot = it.channel_to_slot(ch) if it is not None else 0
        for (row, sl), call in self.calls2[s].items():
            if int(round(call.freq_hz - self.centers[s])) != off:
                continue
            if sl == slot:
                call.last_voice = self.clock
                self.stats.grant_refreshes += 1
                return
            if (row, slot) in self.calls2[s]:
                continue        # our slot's call rides another entry
            self.calls2[s][(row, slot)] = VoiceCall(
                row=row, tg=tg, src=int(fields.get("src", 0) or 0),
                freq_hz=freq, system=s, granted_at=self.clock,
                last_voice=self.clock, slot=slot)
            self.stats.grants += 1
            self.log.append(f"[{self.clock:7.2f}s] sys {s} GRANT TG "
                            f"{tg} -> p2 row {row} slot {slot} @ "
                            f"{freq / 1e6:.4f} MHz")
            return
        if not self.tg_policy(tg):
            self.stats.policy_drops += 1
            return
        if not self._free[s]:
            self.stats.busy_drops += 1
            return
        row = self._free[s].pop(0)
        self.offs[s, 1 + row] = off
        self.calls2[s][(row, slot)] = VoiceCall(
            row=row, tg=tg, src=int(fields.get("src", 0) or 0),
            freq_hz=freq, system=s, granted_at=self.clock,
            last_voice=self.clock, slot=slot)
        self.stats.grants += 1
        self.log.append(f"[{self.clock:7.2f}s] sys {s} GRANT TG {tg} "
                        f"-> p2 row {row} slot {slot} @ "
                        f"{freq / 1e6:.4f} MHz")

    def _walk_cc_events(self) -> None:
        for s in range(self.S):
            evs = self._cc_host.ctxs[s].events
            for ev in evs[self._ev_cursor[s]:]:
                if ev.fields.get("grant"):
                    self._on_grant(s, ev.fields)
            self._ev_cursor[s] = len(evs)

    def _tick_releases(self) -> None:
        for s in range(self.S):
            for row, call in list(self.calls[s].items()):
                idle = self.clock - call.last_voice
                age = self.clock - call.granted_at
                if idle > self.hangtime_s and age > self.grant_grace_s:
                    self.log.append(f"[{self.clock:7.2f}s] sys {s} "
                                    f"RELEASE TG {call.tg} row {row} "
                                    f"({call.pcm_samples} samples)")
                    del self.calls[s][row]
                    self._free[s].append(row)
                    self.offs[s, 1 + row] = self.offs[s, 0]
                    self.stats.releases += 1
            for key, call in list(self.calls2[s].items()):
                idle = self.clock - call.last_voice
                age = self.clock - call.granted_at
                if idle > self.hangtime_s and age > self.grant_grace_s:
                    row, slot = key
                    self.log.append(f"[{self.clock:7.2f}s] sys {s} "
                                    f"RELEASE TG {call.tg} p2 row "
                                    f"{row} slot {slot} "
                                    f"({call.pcm_samples} samples)")
                    del self.calls2[s][key]
                    self.stats.releases += 1
                    # park the row only once BOTH slots are done
                    if not any(r == row for r, _ in self.calls2[s]):
                        self._free[s].append(row)
                        self.offs[s, 1 + row] = self.offs[s, 0]

    # -- the step -------------------------------------------------------------
    def prefetch(self, wide: np.ndarray):
        """Start the async host→device upload of the next [S, B]
        wideband block (sharded over the mesh) and return the device
        handle that :meth:`step` accepts in place of a host array.
        Double-buffering hides the transfer under the SPMD programs,
        exactly as the reference's dongle thread
        fills the next ring buffer while the demod thread consumes the
        current one (src/io/radio/rtl_sdr_fm.cpp USB callback + ring)."""
        import jax
        if isinstance(wide, np.ndarray):
            if np.iscomplexobj(wide):
                wide = np.stack([wide.real, wide.imag],
                                axis=-1).astype(np.float32)
            elif wide.dtype != np.uint8:
                wide = np.ascontiguousarray(wide, dtype=np.float32)
            wide = jax.device_put(wide, self._w_shard)
        return wide

    def step(self, wide: np.ndarray, prefetch=None) -> np.ndarray:
        """One [S, B] wideband block per system → [S, n_vc, T] PCM.

        ``wide=None`` consumes the block most recently queued via
        ``prefetch=``; passing the NEXT host block as ``prefetch=``
        enqueues its sharded upload right after this block's SPMD
        program dispatches, so the transfer rides under its execution."""
        import jax
        if wide is None:
            wide = self._next_block
            self._next_block = None
            if wide is None:
                raise ValueError("step(None) without a prefetched block")
        elif self._next_block is not None:
            # a fresh block supersedes a queued prefetch (see
            # engine.fleettrunk.TrunkedFleet.step)
            self.log.append(f"[{self.clock:7.2f}s] WARN: prefetched "
                            "block dropped (step called with a fresh "
                            "block while one was queued)")
            self._next_block = None
        if isinstance(wide, np.ndarray):
            # ship float planes — or, better, raw CU8 planes (the SDR
            # wire format, 4x less upload; converted on device by the
            # row extractor)
            if np.iscomplexobj(wide):
                wide = np.stack([wide.real, wide.imag],
                                axis=-1).astype(np.float32)
            elif wide.dtype != np.uint8:
                wide = np.ascontiguousarray(wide, dtype=np.float32)
            wide = jax.device_put(wide, self._w_shard)
        block_s = self.B / self.fs
        out = self.step_fn(
            wide, jax.device_put(self.offs, self._o_shard))
        if prefetch is not None:
            # the SPMD program is enqueued; the next block's upload
            # streams while it executes
            self._next_block = self.prefetch(prefetch)
        # ONE device-to-host exchange for all four outputs
        blob, valid, msg, pcm, _ok = jax.device_get(out)
        # pcm: [S, R_v, T]
        # voice activity refreshes hangtime (CC-parked rows carry FSK,
        # but their decode output is masked to the active-call rows)
        act_mask = np.zeros(pcm.shape[:2] + (1,), pcm.dtype)
        if pcm.shape[2]:
            energy = np.abs(pcm).mean(axis=2)      # [S, R_v]
            for s in range(self.S):
                for row, call in self.calls[s].items():
                    act_mask[s, row] = 1.0
                    if energy[s, row] > 1e-4:
                        call.last_voice = self.clock + block_s
                        call.pcm_samples += int(pcm.shape[2])
                # p25_mixed: PCM row 2·row + slot
                for (row, slot), call in self.calls2[s].items():
                    r = 2 * row + slot
                    act_mask[s, r] = 1.0
                    if energy[s, r] > 1e-4:
                        call.last_voice = self.clock + block_s
                        call.pcm_samples += int(pcm.shape[2])
        self.clock += block_s
        self.blocks += 1
        self._parse_blobs(blob, valid, msg)
        self._walk_cc_events()
        self._tick_releases()
        return pcm * act_mask

    # -- introspection --------------------------------------------------------
    def row_dicts(self) -> list[dict]:
        out = []
        for s in range(self.S):
            out.append({"id": (s, 0), "freq_hz": float(self.offs[s, 0]),
                        "state": "cc", "tg": 0})
            for v in range(self.n_vc):
                call = self.calls[s].get(v)
                slots = {sl: c for (r, sl), c in self.calls2[s].items()
                         if r == v}
                if slots:
                    state = "p2 " + " ".join(
                        f"s{sl} TG {c.tg}"
                        for sl, c in sorted(slots.items()))
                    tg = next(iter(slots.values())).tg
                elif call:
                    state, tg = f"voice TG {call.tg}", call.tg
                else:
                    state, tg = "idle", 0
                out.append({
                    "id": (s, 1 + v),
                    "freq_hz": float(self.offs[s, 1 + v]),
                    "state": state, "tg": tg})
        return out
