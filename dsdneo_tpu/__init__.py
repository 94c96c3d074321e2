"""dsdneo_tpu — a batched, many-channel digital speech decoder framework.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
decoder `dsd-neo` (see /root/reference): RF I/Q in, demodulated symbols,
FEC-corrected frames, decoded land-mobile-radio protocols (P25 Phase 1/2,
DMR, NXDN, D-STAR, dPMR, M17, YSF, X2-TDMA, EDACS, ProVoice), and
synthesized IMBE/AMBE voice out — recast as a batched, many-channel
device pipeline instead of a single-channel sample loop.

Architecture (batch-first, not a port):
  - ``dsp``      pure-functional block DSP over ``[C, B]`` framed I/Q
                 (C channels batched per device step).
  - ``symbols``  feed-forward timing recovery (Oerder&Meyr style spectral
                 timing estimation — parallel, no per-sample feedback loop)
                 and dibit slicing.
  - ``fec``      block codes as soft-decision maximum-likelihood codebook
                 matmuls where feasible; algebraic decoders
                 (RS/BCH/trellis) in exact integer lanes elsewhere.
  - ``protocol`` host-side frame parsers and trunking state machines.
  - ``vocoder``  IMBE/AMBE parameter decode + harmonic synthesis as a
                 batched device kernel.
  - ``engine``   the host orchestration loop: frame sync bookkeeping,
                 protocol dispatch, events, trunk following.
  - ``parallel`` mesh/sharding for scaling the channel axis over devices.
  - ``io``       I/Q capture/replay, metadata sidecars, PCM/network IO.

Reference parity citations use ``file:line`` into ``/root/reference``.
"""

__version__ = "0.1.0"
