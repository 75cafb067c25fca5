"""Domain-decomposition (nested-dissection) distributed pose-graph solver.

Replaces the replicated dense Cholesky of `distributed.py` — the Amdahl wall
of the round-3 scaling artifact — with an EXACT two-level direct method that
keeps all O(D^3) work device-local:

  - the pose chain is split into `nd` contiguous segments, one per device;
  - one separator pose per segment cut, plus one promoted endpoint per
    cross-segment loop edge, form a small replicated INTERFACE (dimension
    6*NB, NB ~ nd + #cross-loops — tens, not thousands);
  - every edge is routed (host-side, numpy) to the device owning its
    interior endpoint, so the interior Hessian A is block-diagonal across
    devices by construction;
  - each device factorizes its own (6K/nd)^2 interior block, forms its
    Schur contribution C_d - B_d^T A_d^{-1} B_d, and only the tiny (6NB)^2
    interface system is psum-reduced and solved replicated;
  - per-pose covariance (ceres::Covariance replacement,
    /root/reference/src/pose_graph/pose_graph.cpp:345-351) comes from the
    same factorization: interior blocks = diag(A^{-1}) + diag(W S^{-1} W^T)
    with W = A^{-1}B, interface blocks = diag blocks of S^{-1} — all local
    except the small replicated S.

Exactness: the damping eps is added to the A and C diagonals BEFORE the
Schur complement, so the method is algebraically the exact factorization of
the dense path's H + eps*I — dd and dense agree to floating-point roundoff
(equivalence-tested against `distributed_pose_graph_solve` and the
single-device dense solve).

Scaling: per-device factorization work drops as (K/nd)^3 (nd^3 total
speedup of the Cholesky phase vs the replicated dense solve), assembly
shards linearly, and the collective volume per GN iteration falls from
O((6K)^2) floats (the dense H psum) to O((6NB)^2): the whole solve scales
instead of hitting the replicated-Cholesky wall
(/root/reference/src/pose_graph/pose_graph.cpp:266 is the one-core sparse
analogue this out-scales).
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..factors.priors import relpose_residual_jacobians, rollpitch_residual_jacobians
from ..geom import quat_mul, quat_normalize, so3_exp_quat
from .distributed import _huber_weight

_EPS = 1e-8


def _pow2(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _route(nd: int, Ki: int, owner_of, idxs, cap: int):
    """Distribute edge indices across devices by owner; returns
    (nd, cap) int32 slot arrays into the global edge list plus a validity
    mask (padding rows point at edge 0, masked out)."""
    buckets = [[] for _ in range(nd)]
    for k in idxs:
        buckets[owner_of(k)].append(k)
    slot = np.zeros((nd, cap), np.int32)
    valid = np.zeros((nd, cap), bool)
    for d in range(nd):
        b = buckets[d]
        if len(b) > cap:
            # cap comes from route_family's independent owner pass; a
            # mismatch would silently drop edges from the solve — fail loud
            raise AssertionError(
                f"dd _route capacity mismatch: device {d} got {len(b)} edges "
                f"> cap={cap}"
            )
        slot[d, : len(b)] = b
        valid[d, : len(b)] = True
    return slot, valid


def dd_partition(nd: int, K: int, e_i, e_j, e_valid, rp_i, rp_valid,
                 loop_i, loop_j, loop_valid):
    """Host-side partitioner. Segments device d owns poses [d*Ki,(d+1)*Ki);
    interface = segment-cut separators + one promoted endpoint per
    cross-segment loop edge. Returns the routing arrays consumed by the
    jitted solver (all static-shaped; capacities pow2-bucketed so the
    compiled program is reused across calls)."""
    Ki = K // nd
    seg = lambda p: min(int(p) // Ki, nd - 1)

    e_i = np.asarray(e_i); e_j = np.asarray(e_j)
    e_valid = np.asarray(e_valid)
    rp_i = np.asarray(rp_i); rp_valid = np.asarray(rp_valid)
    loop_i = np.asarray(loop_i); loop_j = np.asarray(loop_j)
    loop_valid = np.asarray(loop_valid)

    interface = [d * Ki for d in range(1, nd)]
    iface_set = set(interface)
    # promote the later endpoint of every cross-segment edge — LOOP edges
    # and sequential-family edges alike — unless an endpoint already is
    # interface, which un-crosses it. The chain edges optimize.py builds
    # always cross exactly at a cut (e_j == d*Ki is a separator), so the
    # e-family pass promotes nothing today; it enforces the routing
    # invariant (every edge has an interior-or-interface placement for both
    # endpoints) instead of assuming the caller's edge topology.
    for fam_i, fam_j, fam_valid in (
        (loop_i, loop_j, loop_valid),
        (e_i, e_j, e_valid),
    ):
        for k in np.nonzero(np.asarray(fam_valid))[0]:
            i, j = int(fam_i[k]), int(fam_j[k])
            if i in iface_set or j in iface_set:
                continue
            if seg(i) != seg(j):
                p = max(i, j)
                iface_set.add(p)
                interface.append(p)
    NB = _pow2(len(interface))
    # the with_cov back-solve shards S^{-1} block-columns as NB // nd per
    # device: NB must divide evenly (structurally true for pow2 NB >= 8 and
    # pow2 nd <= 8, made explicit here so a future _pow2 change fails safe)
    if NB % nd != 0:
        NB = ((NB + nd - 1) // nd) * nd
    bnd_glob = np.zeros(NB, np.int32)
    bnd_glob[: len(interface)] = np.asarray(interface, np.int32)
    bnd_valid = np.zeros(NB, bool)
    bnd_valid[: len(interface)] = True
    is_iface = np.zeros(K, bool)
    is_iface[bnd_glob[bnd_valid]] = True
    slot_of = {p: s for s, p in enumerate(bnd_glob[bnd_valid])}

    def owner(i, j=None):
        if not is_iface[i]:
            return seg(i)
        if j is not None and not is_iface[j]:
            return seg(j)
        return 0

    def aug(p, d):
        """Augmented local index of pose p on device d."""
        return Ki + slot_of[p] if is_iface[p] else int(p) - d * Ki

    # ---- route each edge family -----------------------------------------
    def route_family(idx_valid, ends):
        counts = np.zeros(nd, np.int64)
        for k in idx_valid:
            counts[owner(*ends(k))] += 1
        cap = _pow2(int(counts.max()) if len(idx_valid) else 1)
        return cap

    ev = np.nonzero(e_valid)[0]
    cap_e = route_family(ev, lambda k: (e_i[k], e_j[k]))
    e_slot, e_ok = _route(nd, Ki, lambda k: owner(e_i[k], e_j[k]), ev, cap_e)

    rv = np.nonzero(rp_valid)[0]
    cap_r = route_family(rv, lambda k: (rp_i[k],))
    r_slot, r_ok = _route(nd, Ki, lambda k: owner(rp_i[k]), rv, cap_r)

    lv = np.nonzero(loop_valid)[0]
    cap_l = route_family(lv, lambda k: (loop_i[k], loop_j[k]))
    l_slot, l_ok = _route(nd, Ki, lambda k: owner(loop_i[k], loop_j[k]), lv, cap_l)

    # augmented placement indices per routed edge endpoint
    def aug_of(slot, ok, src):
        out = np.zeros_like(slot)
        for d in range(nd):
            for c in range(slot.shape[1]):
                if ok[d, c]:
                    out[d, c] = aug(int(src[slot[d, c]]), d)
        return out

    return dict(
        Ki=Ki, NB=NB,
        bnd_glob=bnd_glob, bnd_valid=bnd_valid, is_iface=is_iface,
        e_slot=e_slot, e_ok=e_ok,
        e_ai=aug_of(e_slot, e_ok, e_i), e_aj=aug_of(e_slot, e_ok, e_j),
        r_slot=r_slot, r_ok=r_ok, r_ai=aug_of(r_slot, r_ok, rp_i),
        l_slot=l_slot, l_ok=l_ok,
        l_ai=aug_of(l_slot, l_ok, loop_i), l_aj=aug_of(l_slot, l_ok, loop_j),
    )


def dd_pose_graph_solve(
    mesh: Mesh,
    t, q, active, fixed,
    e_i, e_j, e_dt, e_dq, e_sqrt, e_valid,
    rp_i, rp_q, rp_sqrt, rp_valid,
    loop_i=None, loop_j=None, loop_dt=None, loop_dq=None,
    loop_w=None, loop_valid=None,
    iters: int = 10,
    with_cov: bool = False,
    huber_delta: float = 0.1,
):
    """Domain-decomposition distributed GN (drop-in for
    distributed_pose_graph_solve; same signature/returns). Requires
    K % mesh_size == 0 and mesh_size >= 2."""
    nd = int(mesh.devices.size)
    K = int(t.shape[0])
    if nd < 2 or K % nd != 0:
        raise ValueError(f"dd solver needs nd>=2 and K%nd==0 (K={K}, nd={nd})")
    dtype = t.dtype

    if loop_i is None:
        L = nd
        loop_i = jnp.zeros(L, jnp.int32)
        loop_j = jnp.zeros(L, jnp.int32)
        loop_dt = jnp.zeros((L, 3), dtype)
        loop_dq = jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (L, 1))
        loop_w = jnp.zeros(L, dtype)
        loop_valid = jnp.zeros(L, bool)

    part = dd_partition(nd, K, e_i, e_j, e_valid, rp_i, rp_valid,
                        loop_i, loop_j, loop_valid)
    NB, Ki = part["NB"], part["Ki"]

    # gather routed edge payloads on host (cheap) so the device never sees
    # the global edge list layout
    gi = lambda arr, slot: jnp.asarray(np.asarray(arr)[slot])
    run = _build_dd_solver(mesh, K, Ki, NB, iters, with_cov, huber_delta,
                           int(part["e_slot"].shape[1]),
                           int(part["r_slot"].shape[1]),
                           int(part["l_slot"].shape[1]))
    t2, q2, cov, cost = run(
        t, q, active.astype(bool), fixed.astype(bool),
        jnp.asarray(part["bnd_glob"]), jnp.asarray(part["bnd_valid"]),
        jnp.asarray(part["is_iface"]),
        gi(e_i, part["e_slot"]), gi(e_j, part["e_slot"]),
        gi(e_dt, part["e_slot"]), gi(e_dq, part["e_slot"]),
        gi(e_sqrt, part["e_slot"]),
        jnp.asarray(part["e_ok"]), jnp.asarray(part["e_ai"]),
        jnp.asarray(part["e_aj"]),
        gi(rp_i, part["r_slot"]), gi(rp_q, part["r_slot"]),
        gi(rp_sqrt, part["r_slot"]),
        jnp.asarray(part["r_ok"]), jnp.asarray(part["r_ai"]),
        gi(loop_i, part["l_slot"]), gi(loop_j, part["l_slot"]),
        gi(loop_dt, part["l_slot"]), gi(loop_dq, part["l_slot"]),
        gi(loop_w, part["l_slot"]),
        jnp.asarray(part["l_ok"]), jnp.asarray(part["l_ai"]),
        jnp.asarray(part["l_aj"]),
    )
    if with_cov:
        return t2, q2, cov, cost
    return t2, q2, cost


@functools.lru_cache(maxsize=16)
def _build_dd_solver(mesh: Mesh, K: int, Ki: int, NB: int, iters: int,
                     with_cov: bool, huber_delta: float,
                     Ec: int, Rc: int, Lc: int):
    axis = mesh.axis_names[0]
    nd = int(mesh.devices.size)
    Da = 6 * (Ki + NB)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(),          # t q active fixed (replicated)
            P(), P(), P(),               # bnd_glob bnd_valid is_iface
            P(axis), P(axis), P(axis), P(axis), P(axis),  # e payload
            P(axis), P(axis), P(axis),   # e_ok e_ai e_aj
            P(axis), P(axis), P(axis),   # rp payload
            P(axis), P(axis),            # r_ok r_ai
            P(axis), P(axis), P(axis), P(axis), P(axis),  # loop payload
            P(axis), P(axis), P(axis),   # l_ok l_ai l_aj
        ),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def run(t, q, active, fixed, bnd_glob, bnd_valid, is_iface,
            e_gi, e_gj, e_dt, e_dq, e_sqrt, e_ok, e_ai, e_aj,
            r_gi, r_q, r_sqrt, r_ok, r_ai,
            l_gi, l_gj, l_dt, l_dq, l_w, l_ok, l_ai, l_aj):
        dtype = t.dtype
        sq = lambda a: a.reshape(a.shape[1:])  # drop the sharded leading 1
        e_gi, e_gj, e_dt, e_dq, e_sqrt, e_ok, e_ai, e_aj = map(
            sq, (e_gi, e_gj, e_dt, e_dq, e_sqrt, e_ok, e_ai, e_aj))
        r_gi, r_q, r_sqrt, r_ok, r_ai = map(sq, (r_gi, r_q, r_sqrt, r_ok, r_ai))
        l_gi, l_gj, l_dt, l_dq, l_w, l_ok, l_ai, l_aj = map(
            sq, (l_gi, l_gj, l_dt, l_dq, l_w, l_ok, l_ai, l_aj))

        me = jax.lax.axis_index(axis)
        my_poses = me * Ki + jnp.arange(Ki)
        alive = active & ~fixed
        int_alive6 = jnp.repeat(alive[my_poses] & ~is_iface[my_poses], 6
                                ).astype(dtype)
        bnd_alive = bnd_valid & alive[bnd_glob]
        bnd_alive6 = jnp.repeat(bnd_alive, 6).astype(dtype)
        augmask = jnp.concatenate([int_alive6, bnd_alive6])  # (Da,)

        ohA = lambda ai: jax.nn.one_hot(ai, Ki + NB, dtype=dtype)
        expand = lambda Jb, o: jnp.einsum("nrk,nb->nrbk", Jb, o).reshape(
            Jb.shape[0], Jb.shape[1], Da)

        def assemble(tt, qq, anneal):
            # relative-pose edges
            def edge_one(k):
                r, Ji, Jj = relpose_residual_jacobians(
                    e_dt[k], e_dq[k], tt[e_gi[k]], qq[e_gi[k]],
                    tt[e_gj[k]], qq[e_gj[k]])
                S = e_sqrt[k]
                m = e_ok[k].astype(dtype)
                return (S @ r) * m, (S @ Ji) * m, (S @ Jj) * m

            rE, JiE, JjE = jax.vmap(edge_one)(jnp.arange(Ec))
            JE = expand(JiE, ohA(e_ai)) + expand(JjE, ohA(e_aj))

            # roll-pitch edges
            def rp_one(k):
                r, J = rollpitch_residual_jacobians(r_q[k], qq[r_gi[k]])
                S = r_sqrt[k]
                m = r_ok[k].astype(dtype)
                return (S @ r) * m, (S @ J) * m

            rR, JR0 = jax.vmap(rp_one)(jnp.arange(Rc))
            JR = expand(JR0, ohA(r_ai))

            # loop edges (Huber + graduated non-convexity, as in
            # distributed.py/_loop_rows — equivalence-tested)
            def loop_one(k):
                r, Ji, Jj = relpose_residual_jacobians(
                    l_dt[k], l_dq[k], tt[l_gi[k]], qq[l_gi[k]],
                    tt[l_gj[k]], qq[l_gj[k]])
                s = jnp.sqrt(jnp.maximum(l_w[k], 0.0))
                rsq = jnp.sum((s * r) ** 2)
                d = huber_delta
                if anneal is not None:
                    d = jnp.maximum(d, anneal * jnp.sqrt(rsq + 1e-18))
                hw = _huber_weight(rsq, d)
                m = l_ok[k].astype(dtype) * hw * s
                return r * m, Ji * m, Jj * m

            rL, JiL, JjL = jax.vmap(loop_one)(jnp.arange(Lc))
            JL = expand(JiL, ohA(l_ai)) + expand(JjL, ohA(l_aj))

            Jf = jnp.concatenate(
                [JE.reshape(-1, Da), JR.reshape(-1, Da), JL.reshape(-1, Da)])
            rf = jnp.concatenate([rE.reshape(-1), rR.reshape(-1), rL.reshape(-1)])
            Jf = Jf * augmask[None, :]
            H = jax.lax.dot_general(
                Jf, Jf, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=dtype)
            b = -jax.lax.dot_general(
                Jf, rf[:, None], dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=dtype)[:, 0]
            cost = 0.5 * jnp.sum(rf * rf)
            return H, b, cost

        nI = 6 * Ki

        def schur(tt, qq, anneal):
            """One assembly + exact Schur factorization of H + eps*I.
            Returns what both the solve and the covariance need."""
            Haug, baug, cost = assemble(tt, qq, anneal)
            A = Haug[:nI, :nI] + jnp.diag(
                _EPS * int_alive6 + (1.0 - int_alive6))
            B = Haug[:nI, nI:]
            Cd = Haug[nI:, nI:] + (_EPS / nd) * jnp.diag(bnd_alive6)
            bI = baug[:nI]
            bBd = baug[nI:]
            LA = jnp.linalg.cholesky(A)
            W = jax.scipy.linalg.cho_solve((LA, True), B)      # A^{-1} B
            y = jax.scipy.linalg.cho_solve((LA, True), bI)     # A^{-1} bI
            Sc = Cd - jax.lax.dot_general(
                B, W, dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=dtype)
            gc = bBd - B.T @ y
            S = jax.lax.psum(Sc, axis) + jnp.diag(1.0 - bnd_alive6)
            g = jax.lax.psum(gc, axis)
            cost = jax.lax.psum(cost, axis)
            return LA, W, y, S, g, cost

        bnd_oh = jax.nn.one_hot(bnd_glob, K, dtype=dtype) * \
            bnd_valid.astype(dtype)[:, None]                   # (NB, K)

        def step(i, tq):
            tt, qq = tq
            LA, W, y, S, g, _ = schur(tt, qq, jnp.exp(-1.2 * i.astype(dtype)))
            LS = jnp.linalg.cholesky(S)
            xB = jax.scipy.linalg.cho_solve((LS, True), g)     # (6NB,)
            xI = y - W @ xB                                     # (6Ki,)
            dxg = jax.lax.all_gather(
                xI.reshape(Ki, 6) * int_alive6.reshape(Ki, 6),
                axis, axis=0).reshape(K, 6)
            dxg = dxg + jnp.einsum("bk,bd->kd", bnd_oh, xB.reshape(NB, 6))
            return (tt + dxg[:, :3],
                    quat_normalize(quat_mul(qq, so3_exp_quat(dxg[:, 3:]))))

        t2, q2 = jax.lax.fori_loop(0, iters, step, (t, q))

        if with_cov:
            LA, W, y, S, g, cost = schur(t2, q2, None)
            LS = jnp.linalg.cholesky(S)
            Ainv = jax.scipy.linalg.cho_solve(
                (LA, True), jnp.eye(nI, dtype=dtype))
            U = jax.scipy.linalg.cho_solve((LS, True), W.T)    # S^{-1} W^T
            # diag 6x6 blocks of A^{-1} + W S^{-1} W^T (interior poses)
            Ad = Ainv.reshape(Ki, 6, Ki, 6)
            diagA = jax.vmap(lambda k: Ad[k, :, k, :])(jnp.arange(Ki))
            Wb = W.reshape(Ki, 6, 6 * NB)
            Ub = U.reshape(6 * NB, Ki, 6)
            corr = jnp.einsum("kaB,Bkb->kab", Wb, Ub)
            cov_int = diagA + corr                              # (Ki, 6, 6)
            covg = jax.lax.all_gather(cov_int, axis, axis=0).reshape(K, 6, 6)
            # interface poses: exact H^{-1} diagonal blocks are S^{-1}
            # blocks. The block-column solves are SHARDED over the mesh
            # (device d solves only its NB/nd interface slots' columns and
            # all_gathers the diag blocks) — replicating the full S^{-1}
            # costs 2(6NB)^3 and dominated loop-heavy graphs where the
            # promoted interface rivals the interiors in size.
            NBl = NB // nd
            bcols = (me * (6 * NBl) + jnp.arange(6 * NBl))
            rhsS = jax.nn.one_hot(bcols, 6 * NB, dtype=dtype).T
            Scols = jax.scipy.linalg.cho_solve((LS, True), rhsS)
            Sb = Scols.reshape(NB, 6, NBl, 6)
            diagS_l = jax.vmap(lambda b: Sb[me * NBl + b, :, b, :])(
                jnp.arange(NBl))
            diagS = jax.lax.all_gather(diagS_l, axis, axis=0).reshape(NB, 6, 6)
            cov_bnd = jnp.einsum("bk,bij->kij", bnd_oh, diagS)
            covg = jnp.where(is_iface[:, None, None], cov_bnd, covg)
        else:
            _, _, _, _, _, cost = schur(t2, q2, None)
            covg = jnp.zeros((K, 6, 6), dtype)
        return t2, q2, covg, cost

    return run
