"""Multi-device scaling of the distributed pose-graph solve and the
data-parallel window solver, measured on a virtual CPU mesh.

    python scaling_bench.py

The virtual devices share this host's cores, so these numbers check the
plumbing and the algorithmic work split (the domain-decomposition solver's
per-device work shrinks as (K/nd)^3), not the speed of any accelerator.
Prints one JSON line.
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp


def _time(fn, n=3):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _posegraph_problem(K, E, n_loops, rng):
    t = jnp.asarray(np.cumsum(rng.normal(size=(K, 3)) * 0.05, axis=0))
    q = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (K, 1))
    e_i = jnp.asarray(np.minimum(np.arange(E), K - 2), jnp.int32)
    e_j = e_i + 1
    e_dt = jnp.asarray(rng.normal(size=(E, 3)) * 0.05)
    e_dq = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (E, 1))
    e_sqrt = jnp.tile(jnp.eye(6)[None] * 20.0, (E, 1, 1))
    e_valid = jnp.ones(E, bool)
    rp_i = jnp.asarray(np.arange(K) % K, jnp.int32)
    rp_q = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (K, 1))
    rp_sqrt = jnp.tile(jnp.eye(2)[None] * 5.0, (K, 1, 1))
    rp_valid = jnp.ones(K, bool)
    active = jnp.ones(K, bool)
    fixed = jnp.zeros(K, bool).at[0].set(True)
    L = max(16, n_loops)
    loop_i = jnp.asarray(rng.integers(0, K // 2, L), jnp.int32)
    loop_j = jnp.asarray(rng.integers(K // 2, K - 1, L), jnp.int32)
    loop_dt = jnp.asarray(rng.normal(size=(L, 3)) * 0.05)
    loop_dq = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (L, 1))
    loop_w = jnp.ones(L) * 100.0
    loop_valid = jnp.ones(L, bool)
    return (t, q, active, fixed, e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
            rp_i, rp_q, rp_sqrt, rp_valid,
            loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid)


def bench_posegraph_dd(K=1024, iters=3):
    """Measured virtual-mesh sweep: single-device dense baseline vs the dd
    solver at 2/4/8 devices, with covariance (the product configuration)."""
    from isvins_tpu.parallel import make_mesh
    from isvins_tpu.parallel.distributed import distributed_pose_graph_solve
    from isvins_tpu.parallel.dd_solver import dd_pose_graph_solve

    rng = np.random.default_rng(0)
    args = _posegraph_problem(K, K, max(16, K // 16), rng)

    t1 = _time(lambda: distributed_pose_graph_solve(
        make_mesh(1), *args, iters=iters, with_cov=True), n=2)
    print(f"# posegraph K={K} dense 1-dev: {t1*1e3:.0f} ms", file=sys.stderr)
    rows = {"1": {"ms": round(t1 * 1e3, 1), "solver": "dense"}}
    t_dd = {}
    for nd in (2, 4, 8):
        if nd > len(jax.devices()):
            break
        tn = _time(lambda: dd_pose_graph_solve(
            make_mesh(nd), *args, iters=iters, with_cov=True), n=2)
        t_dd[nd] = tn
        rows[str(nd)] = {
            "ms": round(tn * 1e3, 1),
            "solver": "dd",
            "speedup_vs_dense_1dev": round(t1 / tn, 2),
            "efficiency_vs_dense": round(t1 / (nd * tn), 3),
        }
        # per-device efficiency AT FIXED ALGORITHM: the dd method itself needs >= 2 devices, so the 2-device run is the
        # fixed-algorithm reference: eff(nd) = 2 t_dd(2) / (nd t_dd(nd)) —
        # how much of the added silicon the SAME solver converts to speed
        if 2 in t_dd:
            rows[str(nd)]["efficiency_fixed_alg_vs_2dev"] = round(
                2 * t_dd[2] / (nd * tn), 3)
        print(f"# posegraph K={K} dd {nd}-dev: {tn*1e3:.0f} ms "
              f"({t1/tn:.2f}x vs dense, eff_dense {t1/(nd*tn):.2f}, "
              f"eff_fixed {2*t_dd[2]/(nd*tn):.2f})", file=sys.stderr)
    return {
        "K": K, "E": K, "loops": 64, "iters": iters, "with_cov": True,
        "measured_virtual_mesh": rows,
        "note": "8 virtual devices SHARE this host's cores, so these are"
                " lower bounds: replicated phases multiply here but run"
                " concurrently on real chips. efficiency_vs_dense compares"
                " against the DENSE single-device solver (total-speedup"
                " view, includes the algorithmic win); "
                " efficiency_fixed_alg_vs_2dev holds the dd algorithm fixed"
                " and is the honest per-device parallel efficiency.",
    }


def bench_window_dp():
    """Data-parallel window solves (BASELINE configs[4-5]): a batch of 16
    product-shape problems (B=18, F=1000, N=3072) sharded over 1/2/4/8
    devices. Strong scaling: fixed total work. Embarrassingly parallel (no
    collectives inside the solve), so on real chips efficiency is ~1.0 by
    construction; the virtual-mesh numbers only check the plumbing."""
    from isvins_tpu.parallel import make_mesh, make_batch_problem
    from isvins_tpu.parallel.sharded import sharded_batch_solve
    from isvins_tpu.solver import WindowDims

    dims = WindowDims(B=18, Vo=8, F=1000, N=3072)
    NB = 16
    state, imu, proj, priors, G, psi = make_batch_problem(NB, dims, dtype=jnp.float32)
    n_dev_avail = len(jax.devices())
    devs, times = [], []
    nd = 1
    while nd <= min(8, n_dev_avail):
        mesh = make_mesh(nd)
        step, shard = sharded_batch_solve(mesh, dims, iters=5)
        args = shard((state, imu, proj, priors))
        dt = _time(lambda: step(*args, G, psi), n=3)
        devs.append(nd)
        times.append(dt * 1e3)
        print(f"# window-dp {nd} device(s): {dt*1e3:.1f} ms for {NB} solves",
              file=sys.stderr)
        nd *= 2
    return {
        "batch": NB, "dims": "B=18,F=1000,N=3072,iters=5",
        "devices": devs, "measured_ms_virtual_mesh": [round(x, 2) for x in times],
        "collectives_inside_solve": 0,
        "note": "zero-collective data parallelism: multi-chip efficiency is"
                " bounded only by per-device solve time",
    }


def main():
    import isvins_tpu  # noqa: F401  (x64 config)

    out = {
        "metric": "multi_device_scaling_virtual_cpu_mesh",
        "cores": os.cpu_count() or 1,
        "posegraph_dd_K256": bench_posegraph_dd(K=256),
        "posegraph_dd_K1024": bench_posegraph_dd(K=1024),
        "window_solve_data_parallel": bench_window_dp(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
