"""Sliding-window nonlinear least-squares solver.

Replaces Ceres DENSE_SCHUR + DOGLEG (estimator.cpp:1119–1128) with a fully
jitted, statically-shaped Levenberg–Marquardt loop: batched factor kernels
build a dense Jacobian over the pose system via one-hot einsums (dense
products, no scatters), inverse-depth landmarks are eliminated with a
single-matmul Schur complement, and damping/accept logic is branchless inside `lax.while_loop`.
"""

from .window import (  # noqa: F401
    WindowState,
    PriorState,
    ProjFactors,
    ImuFactors,
    RollPitchFactors,
    WindowDims,
    build_normal_equations,
    solve_window,
    retract_state,
    window_cost,
)
