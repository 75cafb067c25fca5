"""Distributed pose-graph Gauss-Newton over a device mesh.

The scaling deliverable of SURVEY.md §2.3 / BASELINE configs[4]: the graph's
edges (sequential VIO edges, roll-pitch edges, Huber-weighted loop edges) are
sharded across devices with `shard_map`; each device assembles the partial
normal equations for its edge shard, the global (6K, 6K) system is reduced
with `lax.psum` over the mesh (ICI collectives), and the replicated dense
Cholesky solve + state update run identically on every device. Gauss-Newton
iterations stay entirely on-device inside one jitted program — the host only
launches it. With `with_cov=True` the per-pose 6x6 covariance blocks of the
dense inverse are returned too (ceres::Covariance replacement,
pose_graph.cpp:345–351), so this path is a drop-in for the single-device
dense solve in `posegraph/optimize.py` above its size threshold.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..factors.priors import relpose_residual_jacobians, rollpitch_residual_jacobians
from ..geom import quat_mul, quat_normalize, so3_exp_quat



def _atb(A, B):
    """A^T @ B via dot_general contracting dim 0 (no transpose materialized)."""
    return jax.lax.dot_general(
        A, B, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=A.dtype,
    )

def _huber_weight(r_norm_sq, delta: float):
    r = jnp.sqrt(jnp.maximum(r_norm_sq, 1e-18))
    return jnp.sqrt(jnp.where(r <= delta, 1.0, delta / r))


def _edge_rows(tt, qq, e_i, e_j, e_dt, e_dq, e_sqrt, e_valid, K, dtype):
    """Relative-pose edges with full 6x6 sqrt-info -> local H, b, cost."""
    D = 6 * K

    def one(k):
        i, j = e_i[k], e_j[k]
        r, Ji, Jj = relpose_residual_jacobians(
            e_dt[k], e_dq[k], tt[i], qq[i], tt[j], qq[j]
        )
        S = e_sqrt[k]
        m = e_valid[k].astype(dtype)
        return (S @ r) * m, (S @ Ji) * m, (S @ Jj) * m

    ks = jnp.arange(e_i.shape[0])
    r, Ji, Jj = jax.vmap(one)(ks)
    oh = lambda idx: jax.nn.one_hot(idx, K, dtype=dtype)
    expand = lambda Jb, o: jnp.einsum("nrk,nb->nrbk", Jb, o).reshape(
        Jb.shape[0], Jb.shape[1], D
    )
    J = expand(Ji, oh(e_i)) + expand(Jj, oh(e_j))
    Jf = J.reshape(-1, D)
    rf = r.reshape(-1)
    return _atb(Jf, Jf), -_atb(Jf, rf), 0.5 * jnp.sum(rf * rf)


def _loop_rows(tt, qq, l_i, l_j, l_dt, l_dq, l_w, l_valid, K, dtype, delta,
               anneal=None):
    """Loop edges: sqrt_info = sqrt(loop_weight) I with Huber(delta) IRLS
    weights (pose_graph.cpp:334–339). `anneal` (0,1] raises the delta to
    max(delta, anneal*||r_w||) — graduated non-convexity, mirroring
    posegraph/optimize.py (equivalence-tested)."""
    D = 6 * K

    def one(k):
        i, j = l_i[k], l_j[k]
        r, Ji, Jj = relpose_residual_jacobians(
            l_dt[k], l_dq[k], tt[i], qq[i], tt[j], qq[j]
        )
        s = jnp.sqrt(jnp.maximum(l_w[k], 0.0))
        rsq = jnp.sum((s * r) ** 2)
        d = delta
        if anneal is not None:
            d = jnp.maximum(d, anneal * jnp.sqrt(rsq + 1e-18))
        hw = _huber_weight(rsq, d)
        m = l_valid[k].astype(dtype) * hw * s
        return r * m, Ji * m, Jj * m

    ks = jnp.arange(l_i.shape[0])
    r, Ji, Jj = jax.vmap(one)(ks)
    oh = lambda idx: jax.nn.one_hot(idx, K, dtype=dtype)
    expand = lambda Jb, o: jnp.einsum("nrk,nb->nrbk", Jb, o).reshape(
        Jb.shape[0], Jb.shape[1], D
    )
    J = expand(Ji, oh(l_i)) + expand(Jj, oh(l_j))
    Jf = J.reshape(-1, D)
    rf = r.reshape(-1)
    return _atb(Jf, Jf), -_atb(Jf, rf), 0.5 * jnp.sum(rf * rf)


def _rp_rows(tt, qq, rp_i, rp_q, rp_sqrt, rp_valid, K, dtype):
    D = 6 * K

    def one(k):
        i = rp_i[k]
        r, J = rollpitch_residual_jacobians(rp_q[k], qq[i])
        S = rp_sqrt[k]
        m = rp_valid[k].astype(dtype)
        return (S @ r) * m, (S @ J) * m

    ks = jnp.arange(rp_i.shape[0])
    r, J = jax.vmap(one)(ks)
    oh = jax.nn.one_hot(rp_i, K, dtype=dtype)
    Jfull = jnp.einsum("nrk,nb->nrbk", J, oh).reshape(-1, D)
    rf = r.reshape(-1)
    return _atb(Jfull, Jfull), -_atb(Jfull, rf), 0.5 * jnp.sum(rf * rf)


def distributed_pose_graph_solve(
    mesh: Mesh,
    t, q, active, fixed,  # (K,3), (K,4), (K,), (K,) — replicated
    e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,  # (E,...) sharded over mesh
    rp_i, rp_q, rp_sqrt, rp_valid,  # (Krp,...) sharded
    loop_i=None, loop_j=None, loop_dt=None, loop_dq=None,
    loop_w=None, loop_valid=None,  # (L,...) sharded, Huber-weighted
    iters: int = 10,
    with_cov: bool = False,
    huber_delta: float = 0.1,
):
    """Run GN with edge-sharded Hessian assembly + psum reduction.
    E, Krp, L must be divisible by the mesh size (pad with invalid edges);
    with_cov=True additionally requires K divisible by the mesh size (the
    covariance back-solve shards block-columns of H^-1 per device and
    all_gathers (nd*K/nd,6,6) back to (K,6,6)).
    Returns (t_opt, q_opt, cost) or (t_opt, q_opt, cov_blocks, cost)."""
    axis = mesh.axis_names[0]
    nd = mesh.devices.size
    K = t.shape[0]
    dtype = t.dtype
    if with_cov and K % nd != 0:
        raise ValueError(
            f"with_cov=True requires K ({K}) divisible by mesh size ({nd}); "
            "pad poses (active=False) to a multiple of the mesh size"
        )

    if loop_i is None:
        L = nd
        loop_i = jnp.zeros(L, jnp.int32)
        loop_j = jnp.zeros(L, jnp.int32)
        loop_dt = jnp.zeros((L, 3), dtype)
        loop_dq = jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (L, 1))
        loop_w = jnp.zeros(L, dtype)
        loop_valid = jnp.zeros(L, bool)

    run = _build_distributed_solver(mesh, K, iters, with_cov, huber_delta)
    t2, q2, cov, cost = run(
        t, q, active, fixed, e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
        rp_i, rp_q, rp_sqrt, rp_valid,
        loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid,
    )
    if with_cov:
        return t2, q2, cov, cost
    return t2, q2, cost


import functools


@functools.lru_cache(maxsize=16)
def _build_distributed_solver(mesh: Mesh, K: int, iters: int, with_cov: bool,
                              huber_delta: float):
    """Build (once per (mesh, config)) the jitted shard_map solver. Without
    this cache every call re-traced AND re-compiled the whole program —
    profiled at 40-80 s per loop closure on the 8-device virtual mesh."""
    axis = mesh.axis_names[0]
    nd = int(mesh.devices.size)
    D = 6 * K

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(),
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
        ),
        out_specs=(P(), P(), P(), P()),
        # the sharded-covariance path derives per-device values from
        # axis_index and restores replication with an all_gather, which the
        # static varying-manual-axes checker cannot infer
        check_vma=False,
    )
    def run(t, q, active, fixed, e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
            rp_i, rp_q, rp_sqrt, rp_valid,
            loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid):
        dtype = t.dtype
        colmask = jnp.repeat(~fixed & active, 6).astype(dtype)

        def build(tt, qq, anneal=None):
            H1, b1, c1 = _edge_rows(
                tt, qq, e_i, e_j, e_dt, e_dq, e_sqrt, e_valid, K, dtype
            )
            H2, b2, c2 = _rp_rows(tt, qq, rp_i, rp_q, rp_sqrt, rp_valid, K, dtype)
            H3, b3, c3 = _loop_rows(
                tt, qq, loop_i, loop_j, loop_dt, loop_dq, loop_w, loop_valid,
                K, dtype, huber_delta, anneal,
            )
            # reduce partial normal equations over the mesh (ICI collective)
            H = jax.lax.psum(H1 + H2 + H3, axis)
            b = jax.lax.psum(b1 + b2 + b3, axis)
            c = jax.lax.psum(c1 + c2 + c3, axis)
            H = H * colmask[:, None] * colmask[None, :] + jnp.diag(1.0 - colmask)
            b = b * colmask
            return H, b, c

        def step(i, tq):
            tt, qq = tq
            H, b, _ = build(tt, qq, jnp.exp(-1.2 * i.astype(dtype)))
            dx = jax.scipy.linalg.cho_solve(
                (jnp.linalg.cholesky(H + 1e-8 * jnp.eye(D, dtype=dtype)), True), b
            )
            d = dx.reshape(K, 6)
            return tt + d[:, :3], quat_normalize(quat_mul(qq, so3_exp_quat(d[:, 3:])))

        t2, q2 = jax.lax.fori_loop(0, iters, step, (t, q))
        H, _, cost = build(t2, q2)
        if with_cov:
            # Per-pose covariance = diagonal 6x6 blocks of H^{-1}
            # (ceres::Covariance replacement). The triangular solves against
            # the identity are 2/3 of the total FLOPs at product scale
            # (2 D^3 vs D^3/3 for the factorization), so they are SHARDED:
            # each device solves only for its own D/nd block-columns of the
            # inverse and extracts its local diagonal blocks; the (K,6,6)
            # result is re-assembled with one all_gather. Only the D^3/3
            # Cholesky itself stays replicated (cheap relative to the
            # solves, and replicating it avoids a second collective).
            L = jnp.linalg.cholesky(H + 1e-8 * jnp.eye(D, dtype=dtype))
            me = jax.lax.axis_index(axis)
            Kl = K // nd  # caller pads K (pow2) to a multiple of the mesh size
            cols = me * (6 * Kl) + jnp.arange(6 * Kl)
            rhs = jax.nn.one_hot(cols, D, dtype=dtype).T  # (D, 6*Kl)
            Hinv_cols = jax.scipy.linalg.cho_solve((L, True), rhs)
            blocks = Hinv_cols.reshape(K, 6, Kl, 6)
            cov_l = jax.vmap(lambda k: blocks[me * Kl + k, :, k, :])(
                jnp.arange(Kl)
            )  # (Kl, 6, 6): this shard's diagonal blocks
            cov = jax.lax.all_gather(cov_l, axis, axis=0).reshape(K, 6, 6)
        else:
            cov = jnp.zeros((K, 6, 6), dtype)
        return t2, q2, cov, cost

    return run
