"""Two-process DCN dryrun: the multi-HOST axis of the scaling story.

The single-host story shards channels over one host's devices
(parallel.mesh.make_sharded_*); scaling past a host means a second
process joined via jax.distributed, with the same channel-sharded SPMD
program now spanning both processes' devices — collectives between
processes ride the DCN.  This script is one process of that pair
(SURVEY §5 "distributed communication backend"):

  python tools/dcn_dryrun.py <process_id> <num_processes> <coord_addr>

Each process contributes 4 virtual CPU devices; the global mesh is
8-wide.  Every process builds the sharded front-end step, feeds its
local shard via jax.make_array_from_process_local_data, and checks the
psum'd fleet power agrees with the NumPy reduction over the GLOBAL
input (proving the cross-process collective really ran).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        + os.environ.get("XLA_FLAGS", ""))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dsdneo_tpu.parallel.mesh import make_sharded_frontend

    devs = np.array(jax.devices())          # 8 global (4 per process)
    assert devs.size == 4 * nproc, devs
    mesh = Mesh(devs, axis_names=("ch",))
    C, B = 16, 4800
    step, in_shard = make_sharded_frontend(mesh, "p25p1", C, B)

    # deterministic GLOBAL input; each process materializes only its
    # local channel rows
    rng = np.random.default_rng(7)
    iq_global = rng.normal(size=(C, B, 2)).astype(np.float32)
    rows_per_proc = C // nproc
    local = iq_global[pid * rows_per_proc:(pid + 1) * rows_per_proc]
    x = jax.make_array_from_process_local_data(in_shard, local,
                                               (C, B, 2))
    dibits, soft, power, fleet = step(x)
    jax.block_until_ready(fleet)

    # the fleet power is a DCN-spanning mean: check vs the host value
    # computed from the GLOBAL input through the same (local) math
    taps_power = float(fleet)
    # reference: run the un-sharded step on this process over all C
    from dsdneo_tpu.dsp import firdes
    from dsdneo_tpu.engine.batched import frontend_step
    from dsdneo_tpu.engine.modes import MODES
    import jax.numpy as jnp
    mode = MODES["p25p1"]
    sps = 48000.0 / mode.symbol_rate
    n_sym = int(B // sps) - 2
    taps = firdes.channel_lpf(48000.0, mode.lpf_profile)
    _d, _s, pw = frontend_step(jnp.asarray(iq_global), taps, sps, n_sym,
                               mode.four_level)
    expect = float(jnp.mean(pw))
    assert abs(taps_power - expect) < 1e-3 * max(abs(expect), 1.0), (
        taps_power, expect)
    print(f"DCN_OK pid={pid} fleet_power={taps_power:.6f}", flush=True)


if __name__ == "__main__":
    main()
