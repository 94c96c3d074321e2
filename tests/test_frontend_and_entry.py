"""The front end against NumPy and its per-platform FIR formulation,
the compile-cache helper, the CLI's platform choice and the chip smoke
script's CPU rehearsal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_fir_discriminate(x, taps):
    """'Same'-aligned FIR (group delay removed) + angle discriminator,
    out[0] = 0, in float64."""
    c = (len(taps) - 1) // 2
    y = np.stack([np.convolve(row, taps, mode="full")[c:c + x.shape[1]]
                  for row in x.astype(np.complex128)])
    prev = np.concatenate([y[:, :1], y[:, :-1]], axis=1)
    return np.angle(y * np.conj(prev)) / np.pi


@pytest.mark.parametrize("C,B,profile", [(1, 517, "p25_c4fm"),
                                         (3, 1000, "6k25"),
                                         (5, 2049, "p25_c4fm")])
def test_fir_and_discriminator_match_numpy(C, B, profile):
    from dsdneo_tpu.dsp import firdes, frontend
    taps = firdes.channel_lpf(48000.0, profile)
    rng = np.random.default_rng(C * B)
    phase = np.cumsum(rng.normal(scale=0.3, size=(C, B)), axis=-1)
    x = (np.exp(1j * phase) + 0.05 * rng.normal(size=(C, B))
         ).astype(np.complex64)
    got = np.asarray(frontend.fm_discriminate(frontend.fir_complex(x, taps)))
    want = _numpy_fir_discriminate(x, taps)
    assert got.shape == (C, B)
    assert np.all(np.abs(got[:, 0]) < 1e-6)     # angle(|y0|^2)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("C,N,ntaps", [(1, 517, 143), (3, 1000, 62),
                                         (2, 4096, 37)])
def test_fft_fir_matches_direct_fir(C, N, ntaps):
    """The GPU formulation of fir_complex (FFT convolution) against the
    direct convolution every other platform runs, both on the CPU."""
    from dsdneo_tpu.dsp import frontend
    rng = np.random.default_rng(N)
    taps = rng.normal(size=ntaps).astype(np.float32)
    x = (rng.normal(size=(C, N)) + 1j * rng.normal(size=(C, N))
         ).astype(np.complex64)
    direct = np.asarray(frontend._fir_complex_direct(x, taps))
    fft = np.asarray(frontend._fir_complex_fft(x, taps))
    scale = np.abs(direct).max()
    np.testing.assert_allclose(fft, direct, atol=2e-6 * scale * ntaps ** .5)


@pytest.mark.parametrize("platform,present,absent", [
    ("cuda", "fft", "convolution"),
    ("cpu", "convolution", "fft")])
def test_fir_formulation_chosen_per_platform(platform, present, absent):
    """fir_complex lowers to an FFT convolution for a CUDA GPU and to a
    direct convolution elsewhere (the one switch for the front end)."""
    import jax
    import jax.numpy as jnp

    from dsdneo_tpu.dsp import firdes, frontend
    taps = firdes.channel_lpf(48000.0, "p25_c4fm")
    f = jax.jit(lambda x: frontend.fir_complex(x, taps))
    sd = jax.ShapeDtypeStruct((4, 3000), jnp.complex64)
    text = f.trace(sd).lower(lowering_platforms=(platform,)).as_text()
    assert present in text and absent not in text


@pytest.fixture
def _restore_cache_config():
    import jax
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_uses_env_dir_only(monkeypatch, tmp_path,
                                         _restore_cache_config):
    import jax

    from dsdneo_tpu.runtime import jaxcache
    before = jax.config.jax_persistent_cache_min_compile_time_secs
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == before


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                           _restore_cache_config):
    import jax

    from dsdneo_tpu.runtime import jaxcache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert jaxcache.DEFAULT_DIR == want
    assert jaxcache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def _env_without_platform():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_platform_gpu_fails_cleanly_without_gpu(tmp_path):
    """--platform gpu on a host whose JAX finds no GPU: exit code 2 and
    one clear message, no traceback."""
    from dsdneo_tpu.io.iq import IqMetadata, write_iq_capture
    path = str(tmp_path / "x.iq")
    write_iq_capture(path, np.zeros(4800, np.complex64),
                     IqMetadata(sample_format="cf32"))
    proc = subprocess.run(
        [sys.executable, "-m", "dsdneo_tpu", "--platform", "gpu",
         "--frontend", "none", "-f1", "--iq-replay", path + ".json"],
        env=_env_without_platform(), cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "--platform gpu: JAX sees no GPU" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_chip_smoke_rehearsal_last_line(tmp_path):
    """chip_smoke.py --rehearse runs every one-card phase on the CPU at
    C=2 and ends in the one-line JSON record."""
    env = _env_without_platform()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"],
                          env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert set(rec) == {"ok", "device"} and rec["ok"] is True
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    # first line: nvidia-smi's "name, power.limit", or why it is missing
    assert lines[0] == "nvidia-smi: not available" or lines[0].count(",") == 1
    for tag in ("[main]", "[correct]", "[trunk]", "[timing]"):
        assert any(ln.startswith(tag) for ln in lines), tag
