"""Device-mesh parallelism for the VIO engine.

The reference's only concurrency is 7 queue-coupled pthreads (SURVEY.md §1).
The scaling story (§2.3) is:

- **data parallelism over sequences**: many EuRoC sequences run concurrently,
  one window problem per mesh slice — `sharded_batch_solve` shards the
  leading sequence axis of every factor/state array with NamedSharding and
  vmaps the full LM window solve under jit; XLA partitions the whole step
  with zero communication (embarrassingly parallel), so scaling efficiency is
  bounded only by compilation and dispatch.

- **model parallelism inside the solve** (for the pose-graph / global BA
  path): keyframe blocks sharded over the mesh with the reduced camera system
  assembled via psum — see parallel/dd_solver.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..factors import ImuNoise, integrate_segment
from ..solver import (
    ImuFactors,
    PriorState,
    ProjFactors,
    WindowDims,
    WindowState,
    solve_window,
)


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def make_batch_problem(n_seq: int, dims: WindowDims, dtype=jnp.float32, seed: int = 0):
    """Synthetic batch of `n_seq` window problems (random but well-conditioned)
    for benchmarking and multi-chip dry runs. Pure numpy construction; no
    dataset required."""
    rng = np.random.default_rng(seed)
    B, F, N = dims.B, dims.F, dims.N

    def mk_seq(s):
        rng_s = np.random.default_rng(seed * 1000 + s)
        # straight-ish trajectory with small rotations
        P_ = np.cumsum(rng_s.normal(size=(B, 3)) * 0.05 + np.array([0.2, 0, 0]), axis=0)
        phi = rng_s.normal(size=(B, 3)) * 0.02
        from ..geom import so3_exp_quat

        Q_ = np.asarray(so3_exp_quat(jnp.asarray(phi)))
        V_ = np.gradient(P_, 0.1, axis=0)
        dep = rng_s.uniform(0.1, 0.5, size=F)
        # observations: random frame pairs
        idx_i = rng_s.integers(0, B - 1, size=N)
        gap = rng_s.integers(1, 4, size=N)
        idx_j = np.minimum(idx_i + gap, B - 1)
        fidx = rng_s.integers(0, F, size=N)
        pts_i = np.concatenate(
            [rng_s.normal(size=(N, 2)) * 0.2, np.ones((N, 1))], axis=1
        )
        pts_j = pts_i + rng_s.normal(size=(N, 3)) * np.array([0.01, 0.01, 0.0])
        # IMU buffers: 20 samples of ~gravity + noise at 200 Hz
        C = 24
        dts = np.zeros((B - 1, C))
        dts[:, :20] = 0.005
        accs = rng_s.normal(size=(B - 1, C, 3)) * 0.05 + np.array([0, 0, 9.81])
        gyrs = rng_s.normal(size=(B - 1, C, 3)) * 0.01
        return P_, Q_, V_, dep, idx_i, idx_j, fidx, pts_i, pts_j, dts, accs, gyrs

    cols = [mk_seq(s) for s in range(n_seq)]
    stack = lambda i: jnp.asarray(np.stack([c[i] for c in cols]), dtype)

    P_, Q_, V_ = stack(0), stack(1), stack(2)
    dep = stack(3)
    idx_i = jnp.asarray(np.stack([c[4] for c in cols]), jnp.int32)
    idx_j = jnp.asarray(np.stack([c[5] for c in cols]), jnp.int32)
    fidx = jnp.asarray(np.stack([c[6] for c in cols]), jnp.int32)
    pts_i, pts_j = stack(7), stack(8)
    dts, accs, gyrs = stack(9), stack(10), stack(11)

    noise = ImuNoise(
        jnp.asarray(0.1, dtype), jnp.asarray(0.01, dtype),
        jnp.asarray(1e-3, dtype), jnp.asarray(1e-4, dtype),
    )

    integrate = jax.vmap(
        jax.vmap(
            lambda d, a, g: integrate_segment(
                d, a, g, a[0], g[0], jnp.zeros(3, dtype), jnp.zeros(3, dtype), noise
            )
        )
    )
    pre = integrate(dts, accs, gyrs)

    state = WindowState(
        P=P_, Q=Q_, V=V_,
        Ba=jnp.zeros((n_seq, B, 3), dtype),
        Bg=jnp.zeros((n_seq, B, 3), dtype),
        tic=jnp.zeros((n_seq, 3), dtype),
        qic=jnp.tile(jnp.array([1.0, 0, 0, 0], dtype), (n_seq, 1)),
        dep=dep,
    )
    imu = jax.vmap(ImuFactors.create)(pre, jnp.ones((n_seq, B - 1), bool))
    proj = ProjFactors(
        idx_i=idx_i, idx_j=idx_j, fidx=fidx, pts_i=pts_i, pts_j=pts_j,
        valid=jnp.ones((n_seq, N), bool),
    )
    priors = jax.vmap(lambda _: PriorState.empty(dims.Vo, dtype))(jnp.arange(n_seq))
    # anchor each sequence (gauge) with a strong SE3+VB prior
    priors = priors._replace(
        se3_t=P_[:, 0], se3_q=Q_[:, 0],
        se3_sqrt=jnp.tile(jnp.eye(6, dtype=dtype)[None] * 100.0, (n_seq, 1, 1)),
        se3_valid=jnp.ones(n_seq, bool),
        vb=jnp.concatenate([V_[:, dims.Vo - 1], jnp.zeros((n_seq, 6), dtype)], axis=1),
        vb_sqrt=jnp.tile(jnp.eye(9, dtype=dtype)[None] * 10.0, (n_seq, 1, 1)),
        vb_valid=jnp.ones(n_seq, bool),
    )
    G = jnp.asarray([0.0, 0.0, 9.81], dtype)
    psi = jnp.asarray(460.0, dtype)
    return state, imu, proj, priors, G, psi


def sharded_batch_solve(mesh: Mesh, dims: WindowDims, iters: int = 10):
    """Returns a jitted function solving a batch of window problems with the
    sequence axis sharded over the mesh (data parallelism; BASELINE
    configs[4–5])."""
    axis = mesh.axis_names[0]

    def shard_leading(tree):
        spec = NamedSharding(mesh, P(axis))
        return jax.tree_util.tree_map(lambda a: jax.device_put(a, spec), tree)

    @partial(jax.jit)
    def step(state, imu, proj, priors, G, psi):
        return jax.vmap(
            lambda st, im, pr, pri: solve_window(
                st, im, pr, pri, G, psi, dims, iters=iters
            )
        )(state, imu, proj, priors)

    return step, shard_leading
