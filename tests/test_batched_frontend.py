"""Batched front-end exchange contracts (the dispatch/finish seam the
fleet pipelines and bench share)."""

import numpy as np


def test_frontend_finish_cofetch_contract():
    """frontend_finish(fe, cofetch=extra) fetches the caller's device
    arrays in the SAME d2h exchange as the candidate blob and returns
    (normal tuple, numpy extras) — bit-identical to separate fetches
    (bench._pipelined_loop drives the same dispatch/finish seam)."""
    import jax.numpy as jnp

    from dsdneo_tpu.engine.dmrbatch import (BatchedDmrVoicePipeline,
                                            synth_voice_stream)
    samples, _d, _b = synth_voice_stream(n_superframes=2, seed=4)
    iq = np.stack([samples.real, samples.imag],
                  axis=-1).astype(np.float32)[None]
    pipe = BatchedDmrVoicePipeline(1, fs=48000.0)
    fe = pipe.frontend_dispatch(iq)
    plain = pipe.frontend_finish(fe)
    extra = jnp.arange(24.0).reshape(4, 6)
    fe2 = pipe.frontend_dispatch(iq)
    got, co = pipe.frontend_finish(fe2, cofetch=extra)
    assert len(got) == len(plain)
    for a, b in zip(plain[1:], got[1:]):     # [0] is the device dibits
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(co), np.asarray(extra))
    # the bench loop end to end (cofetch engaged from iteration 2)
    import bench
    step_s = bench._pipelined_loop(pipe, jnp.asarray(iq), 3)
    assert step_s > 0
