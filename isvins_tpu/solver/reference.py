"""The float32 window solve held to its plain reference: the same solver in
float64 on the CPU backend, on the same (float32) inputs.

Used by the CPU tests and by chip_smoke.py's `window_solve` phase."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .window import WindowDims, solve_window

# The reference's product window (include/parameters.h:35–40).
PRODUCT_DIMS = WindowDims(B=18, Vo=8, F=1000, N=3072)
ITERS = 10

# Bounds on |float32 solve - float64 solve| for make_batch_problem(seed=0)
# at PRODUCT_DIMS, ITERS LM iterations: twice the CPU backend's own float32
# deviation on that problem (measured on the CPU backend: cost relative
# 1.046e-3, P 3.936e-2 m, Q 2.486e-3, inverse depth 5.019e-2). A float32
# solve on any device rounds differently, but may lose at most twice what
# float32 loses on the CPU. The deviation is large because this random
# problem has a weakly constrained direction that float32 and float64 LM
# iterates walk apart along after ~5 iterations (after 3 it is 7e-5 m), so
# it moves with any change to the order of float32 operations: re-measure
# and restate these bounds after such a change.
F32_TOL = {"cost_rel": 2.09e-3, "P": 7.87e-2, "Q": 4.97e-3, "dep": 1.004e-1}


def product_problem(dims: WindowDims = PRODUCT_DIMS, seed: int = 0):
    """One float32 window problem (state, imu, proj, priors, G, psi) on the
    default device."""
    from ..parallel import make_batch_problem

    st, imu, proj, pri, G, psi = make_batch_problem(1, dims, jnp.float32, seed)
    first = lambda tree: jax.tree_util.tree_map(lambda a: a[0], tree)
    return first(st), first(imu), first(proj), first(pri), G, psi


def as_float64(tree, device=None):
    """Host copy of `tree` with float leaves widened to float64, placed on
    `device` (the default device when None)."""
    def widen(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a
    return jax.device_put(jax.tree_util.tree_map(widen, tree), device)


def solve(args, dims: WindowDims = PRODUCT_DIMS, iters: int = ITERS):
    """(state, cost) of solve_window as host numpy."""
    state, cost = solve_window(*args, dims, iters=iters)
    return jax.tree_util.tree_map(np.asarray, state), float(cost)


def deviation(out, ref) -> dict:
    """Relative final-cost and max-abs P/Q/inverse-depth deviation of a
    solve from the reference solve."""
    (st, cost), (st_ref, cost_ref) = out, ref
    dev = {"cost_rel": abs(cost - cost_ref) / abs(cost_ref)}
    for k in ("P", "Q", "dep"):
        a = np.asarray(getattr(st, k), np.float64)
        dev[k] = float(np.max(np.abs(a - np.asarray(getattr(st_ref, k)))))
    return dev


def within(dev: dict, tol: dict = F32_TOL) -> bool:
    return all(np.isfinite(dev[k]) and dev[k] <= tol[k] for k in tol)
