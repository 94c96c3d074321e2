"""Fleet orchestration: one serving loop over many channels of mixed
protocols — the production composition of the batched pipelines.

The reference runs one process per monitored channel (SURVEY.md §2.8);
this is the batched answer: a FleetMonitor owns groups of channels, each
group bound to one batched pipeline (voice or control), slices every
pushed [C_total, B] block into per-group sub-batches, and runs each
group's device program.  Voice groups return per-channel PCM; control
groups accumulate trunking events (and can drive TrunkFollowers).  The
terminal channel grid renders straight from ``channel_dicts()``.

Groups share the device serially within a block — each pipeline is
itself a full-device batched program, so inter-group parallelism adds
nothing on one chip; across chips, shard the channel axis per group
(parallel/mesh).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# mode → (pipeline factory, kind)
_VOICE_FACTORIES = {
    "p25p1": ("dsdneo_tpu.engine.voicebatch", "BatchedP25VoicePipeline"),
    "p25p2": ("dsdneo_tpu.engine.p2batch", "BatchedP2VoicePipeline"),
    "dmr": ("dsdneo_tpu.engine.dmrbatch", "BatchedDmrVoicePipeline"),
    "nxdn48": ("dsdneo_tpu.engine.nxdnbatch", "BatchedNxdnVoicePipeline"),
    "nxdn96": ("dsdneo_tpu.engine.nxdnbatch", "BatchedNxdnVoicePipeline"),
    "ysf": ("dsdneo_tpu.engine.ysfbatch", "BatchedYsfVoicePipeline"),
    "dpmr": ("dsdneo_tpu.engine.dpmrbatch", "BatchedDpmrVoicePipeline"),
    "x2tdma": ("dsdneo_tpu.engine.x2batch", "BatchedX2VoicePipeline"),
    "m17": ("dsdneo_tpu.engine.m17batch", "BatchedM17VoicePipeline"),
    "dstar": ("dsdneo_tpu.engine.dstarbatch", "BatchedDstarPipeline"),
}
_CC_FACTORIES = {
    "p25p1": ("dsdneo_tpu.engine.ccbatch", "BatchedP25ControlPipeline"),
    "dmr": ("dsdneo_tpu.engine.ccbatch", "BatchedDmrControlPipeline"),
    "nxdn48": ("dsdneo_tpu.engine.ccbatch", "BatchedNxdnControlPipeline"),
    "nxdn96": ("dsdneo_tpu.engine.ccbatch", "BatchedNxdnControlPipeline"),
    "edacs": ("dsdneo_tpu.engine.ccbatch", "BatchedEdacsControlPipeline"),
}


def _make(table, mode, C, fs, kw):
    import importlib
    if mode not in table:
        raise ValueError(f"no batched pipeline for mode {mode!r}")
    mod_name, cls_name = table[mode]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    if mode == "nxdn96" and "mode" not in kw:
        # both the voice AND the CC NXDN pipelines default to the
        # 2400-baud nxdn48 front end; a 9600-baud group must say so
        kw = dict(kw, mode="nxdn96")
    return cls(C, fs=fs, **kw)


@dataclass
class FleetGroup:
    """One contiguous channel range bound to a pipeline."""
    mode: str
    kind: str                 # "voice" | "cc"
    start: int                # first channel index in the fleet block
    count: int
    pipeline: object
    freqs: list = field(default_factory=list)
    pcm: np.ndarray | None = None


class FleetMonitor:
    """Mixed-protocol fleet over one [C_total, B] block per step.

    ``assign(mode, count, kind="voice", freqs=None, **kw)`` appends a
    group; ``decode_block(iq)`` runs every group's device program over
    its channel slice.  Voice PCM lands in ``group.pcm``; control
    events accumulate in each CC pipeline's per-channel contexts.
    """

    def __init__(self, fs: float = 48000.0, workers: int | None = None):
        self.fs = fs
        self.groups: list[FleetGroup] = []
        self.blocks = 0
        # DSD_NEO_MT (docs/cli.md:585): light 2-thread worker pool —
        # group decodes (host-side catalog parse after the device
        # screen) overlap across groups; default stays single-threaded
        if workers is None:
            from dsdneo_tpu.runtime import config as rtcfg
            workers = 2 if rtcfg.get().mt else 0
        self._pool = None
        if workers:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=workers)

    @property
    def total_channels(self) -> int:
        return sum(g.count for g in self.groups)

    def assign(self, mode: str, count: int, kind: str = "voice",
               freqs=None, **kw) -> FleetGroup:
        table = _VOICE_FACTORIES if kind == "voice" else _CC_FACTORIES
        pipe = _make(table, mode, count, self.fs, kw)
        g = FleetGroup(mode=mode, kind=kind, start=self.total_channels,
                       count=count, pipeline=pipe,
                       freqs=list(freqs or [0.0] * count))
        self.groups.append(g)
        return g

    def decode_block(self, iq: np.ndarray) -> None:
        """Run one fleet block: ``iq`` is [C_total, B(, 2)].

        Three-phase fleet pipelining (the demod/output-ring decoupling
        of the reference's rtl_sdr_fm.cpp applied ACROSS groups):
        phase 1 enqueues every group's front-end device program back
        to back; phase 2 walks the groups — each group's candidate-
        blob fetch and host pick ride under the still-queued programs
        of later groups — and dispatches the second-stage device
        program (voice gather/synthesis) or parses control events;
        phase 3 fetches voice PCM last, after every device program is
        in flight.  Host-device exchanges therefore overlap device
        compute instead of re-serializing at fleet scale."""
        assert iq.shape[0] == self.total_channels, (
            f"block carries {iq.shape[0]} channels, fleet has "
            f"{self.total_channels}")
        staged = []
        for g in self.groups:                       # phase 1: dispatch
            sub = iq[g.start:g.start + g.count]
            p = g.pipeline
            two_stage = hasattr(p, "frontend_dispatch") and (
                hasattr(p, "decode_from_frontend") if g.kind == "voice"
                else hasattr(p, "events_from_frontend"))
            fe = p.frontend_dispatch(sub) if two_stage else None
            staged.append((g, sub, fe))

        def _mid(item):                             # phase 2
            g, sub, fe = item
            p = g.pipeline
            if fe is None:                          # fused fallback
                if g.kind == "voice":
                    g.pcm = p.decode_block(sub)
                else:
                    p.decode_block_events(sub)
                return g, None
            fin = p.frontend_finish(fe)
            if g.kind == "voice":
                return g, p.decode_from_frontend(fin)
            p.events_from_frontend(fin)
            return g, None

        if self._pool is not None:
            handles = list(self._pool.map(_mid, staged))
        else:
            handles = [_mid(s) for s in staged]
        for g, h in handles:                        # phase 3: PCM fetch
            if h is not None:
                g.pcm = g.pipeline.fetch_pcm(h)
        self.blocks += 1

    def events(self, channel: int):
        """All events of a fleet channel (CC groups only)."""
        for g in self.groups:
            if g.start <= channel < g.start + g.count:
                if hasattr(g.pipeline, "events"):
                    return g.pipeline.events(channel - g.start)
                return []
        raise IndexError(channel)

    def channel_dicts(self) -> list[dict]:
        """Channel-grid rows for ui.panes.channel_grid_rows."""
        from dsdneo_tpu.ui.panes import channels_from_contexts
        out = []
        for g in self.groups:
            if g.kind == "cc":
                rows = channels_from_contexts(g.pipeline.ctxs,
                                              freqs=g.freqs)
                for i, r in enumerate(rows):
                    r["id"] = g.start + i
                out.extend(rows)
            else:
                for i in range(g.count):
                    if hasattr(g.pipeline, "channel_state"):
                        # event pipelines (D-STAR, M17) report activity
                        # from decoded frames, not PCM
                        state = g.pipeline.channel_state(i)
                    else:
                        active = False
                        if g.pcm is not None and g.pcm.shape[1] > 0:
                            if g.pcm.shape[0] == 2 * g.count:
                                # 2-slot TDMA pipelines (P25p2) emit
                                # per-slot rows at 2*ch + slot
                                active = (np.abs(
                                    g.pcm[2 * i:2 * i + 2]).max() > 1e-4)
                            else:
                                active = np.abs(g.pcm[i]).max() > 1e-4
                        state = "voice" if active else "idle"
                    out.append({"id": g.start + i,
                                "freq_hz": g.freqs[i],
                                "state": state,
                                "tg": 0})
        return out
