"""Mesh scaling sweep: sharded acquisition + channel-sharded tracking
at 1/2/4/8 devices.

Runs the sharded programs (parallel.mesh / parallel.streaming) at
every mesh size and records samples/s per device.  By default it runs
on the virtual CPU mesh (``--xla_force_host_platform_device_count=8``),
whose devices share the host's physical cores — wall clock there
measures collective + SPMD overhead against the single-device baseline,
not speedup.  ``SWEEP_PLATFORM=gpu`` runs the same sweep over the
host's GPUs.

Prints one JSON object and a markdown table.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    platform = os.environ.get("SWEEP_PLATFORM", "cpu")
    if platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
        )
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from stm32f4_sdr_gps_tpu.config import (AcqConfig, BASEBAND_PLAN,
                                            TrackConfig)
    from stm32f4_sdr_gps_tpu.ops.correlate import code_fft_conj
    from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations
    from stm32f4_sdr_gps_tpu.parallel.mesh import (
        make_mesh,
        replicated,
        shard_code_table,
        shard_track_state,
        sharded_acquisition_power,
    )
    from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
    from stm32f4_sdr_gps_tpu.track.scan import track_block
    from stm32f4_sdr_gps_tpu.track.state import init_state

    plan = BASEBAND_PLAN
    devs = jax.devices()
    print(f"platform={devs[0].platform} devices={len(devs)}",
          file=sys.stderr)

    prns = list(range(1, 33))
    rng = np.random.default_rng(0)
    acq = AcqConfig()
    cfg = TrackConfig()
    table = ca_table_bipolar(prns)
    cfc = code_fft_conj(prns, plan)
    bins = np.asarray(acq.doppler_bins_hz, np.float32)
    rot = doppler_rotations(jnp.asarray(bins), plan.samples_per_epoch,
                            plan.sample_rate_hz)
    e_acq = 8
    acq_epochs = jnp.asarray(
        (rng.standard_normal((e_acq, plan.samples_per_epoch))
         + 1j * rng.standard_normal((e_acq, plan.samples_per_epoch))
         ).astype(np.complex64))
    t_trk = 500
    trk_epochs = jnp.asarray(
        (rng.standard_normal((t_trk, plan.samples_per_epoch))
         + 1j * rng.standard_normal((t_trk, plan.samples_per_epoch))
         ).astype(np.complex64))
    state0 = init_state(32, rng.uniform(0, 1023, 32),
                        rng.uniform(-5e3, 5e3, 32))

    rows = []
    sizes = [n for n in (1, 2, 4, 8) if n <= len(devs)]
    for n in sizes:
        mesh = make_mesh(time=1, chan=n, devices=devs[:n])

        # --- acquisition: PRNs sharded over chan, psum-free (time=1) ---
        with jax.sharding.set_mesh(mesh):
            pw = sharded_acquisition_power(acq_epochs, cfc, rot, mesh)
            pw.block_until_ready()          # compile + warm
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                pw = sharded_acquisition_power(acq_epochs, cfc, rot, mesh)
            pw.block_until_ready()
            acq_s = (time.perf_counter() - t0) / reps

        # --- tracking: 32 channels sharded over the mesh ----------------
        st = shard_track_state(state0, mesh)
        tb = shard_code_table(jnp.asarray(table), mesh)
        with jax.sharding.set_mesh(mesh):
            ep = replicated(trk_epochs, mesh)
            fn = jax.jit(lambda s, e: track_block(s, e, tb, plan, cfg))
            s1, o = fn(st, ep)
            jax.block_until_ready((s1, o))
            reps = 3
            t0 = time.perf_counter()
            s1 = st
            for _ in range(reps):
                s1, o = fn(s1, ep)
            jax.block_until_ready((s1, o))
            trk_s = (time.perf_counter() - t0) / reps

        rt = t_trk * 1e-3 / trk_s
        rows.append(dict(
            devices=n,
            acq_ms_32prn=round(acq_s * 1e3, 1),
            track_rt_multiple=round(rt, 2),
            track_samples_per_s_per_chip=round(
                plan.sample_rate_hz * rt / n, 1),
        ))
        print(f"n={n}: acq {acq_s*1e3:.1f} ms, tracking {rt:.2f}x RT "
              f"({rows[-1]['track_samples_per_s_per_chip']:.3g} "
              f"samples/s/chip)", file=sys.stderr)

    # --- fixed-work-per-device mode ------------------------------------
    # On the shared-core virtual mesh, the fixed-TOTAL-work sweep above
    # confounds SPMD overhead with core contention.  Here each point
    # compares the SAME total work (32*n channels / 8*n PRNs) run
    # (a) sharded over an n-device mesh vs (b) unsharded on one device —
    # both use every physical core, so the ratio isolates the
    # SPMD/collective/partitioning overhead.
    fixed_rows = []
    for n in sizes:
        n_ch = 32 * n
        prns_n = [(i % 32) + 1 for i in range(n_ch)]
        table_n = ca_table_bipolar(prns_n)
        st_n = init_state(n_ch, rng.uniform(0, 1023, n_ch),
                          rng.uniform(-5e3, 5e3, n_ch))
        t_fix = 200
        ep_fix = trk_epochs[:t_fix]

        def timed(fn, *args, reps=3):
            r = fn(*args)
            jax.block_until_ready(r)
            t0 = time.perf_counter()
            for _ in range(reps):
                r = fn(*args)
            jax.block_until_ready(r)
            return (time.perf_counter() - t0) / reps

        # (b) unsharded single-device baseline at the same total work
        tb1 = jnp.asarray(table_n)
        fn1 = jax.jit(lambda s, e: track_block(s, e, tb1, plan, cfg))
        t_single = timed(fn1, st_n, ep_fix)

        # (a) sharded over the n-device mesh
        if n == 1:
            t_shard = t_single
        else:
            mesh = make_mesh(time=1, chan=n, devices=devs[:n])
            st_s = shard_track_state(st_n, mesh)
            tb_s = shard_code_table(jnp.asarray(table_n), mesh)
            with jax.sharding.set_mesh(mesh):
                ep_s = replicated(ep_fix, mesh)
                fns = jax.jit(lambda s, e: track_block(s, e, tb_s, plan, cfg))
                t_shard = timed(fns, st_s, ep_s)
        fixed_rows.append(dict(
            devices=n, channels=n_ch,
            track_single_s=round(t_single, 4),
            track_sharded_s=round(t_shard, 4),
            spmd_overhead_pct=round(100.0 * (t_shard / t_single - 1.0), 1),
        ))
        print(f"fixed-work n={n}: {n_ch} ch single {t_single*1e3:.0f} ms "
              f"sharded {t_shard*1e3:.0f} ms "
              f"overhead {fixed_rows[-1]['spmd_overhead_pct']:+.1f}%",
              file=sys.stderr)

    out = dict(
        platform=devs[0].platform,
        physical_cores=os.cpu_count(),
        virtual_mesh=devs[0].platform == "cpu",
        device_kind=devs[0].device_kind,
        note=("on the virtual CPU mesh the fixed-work rows compare "
              "sharded and unsharded runs at the SAME total work, "
              "isolating SPMD/collective overhead; the shared-core rows "
              "are contention-confounded there (virtual devices share "
              "the host's cores)"),
        acq_epochs=e_acq, track_epochs=t_trk, channels=32,
        fixed_work_rows=fixed_rows,
        shared_core_rows_contention_confounded=rows,
    )
    print(json.dumps(out))

    print("\n| devices | acq 32-PRN cube (ms) | tracking ×RT "
          "| samples/s/chip |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['devices']} | {r['acq_ms_32prn']} "
              f"| {r['track_rt_multiple']} "
              f"| {r['track_samples_per_s_per_chip']:,.0f} |")


if __name__ == "__main__":
    main()
