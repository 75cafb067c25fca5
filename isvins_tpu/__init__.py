"""isvins_tpu — a JAX visual-inertial SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of IS-VINS
(lyeemax/IS-VINS): optical-flow feature tracking, IMU preintegration,
sliding-window nonlinear least-squares VIO with two-stage marginalization +
information sparsification, and an information-structured pose graph with
loop closure and online covariance.

Design stance (see SURVEY.md §7): keep the *math contract* of the reference
(factor residuals, two-stage marginalization semantics, window sizes), replace
the *architecture* — Ceres residual blocks become batched, statically-shaped
factor kernels; pointer-rich track lists become fixed-capacity SoA arrays with
validity masks; the 7-thread queue topology becomes a host driver streaming
frames into jitted device super-steps.

Precision policy: the small, numerically delicate linear algebra
(marginalization eigendecompositions, ≤60×60) runs in float64; the batched hot
paths (factor evaluation, Schur, image kernels, Hamming matching) are
float32. We enable x64 globally so host-side math defaults to double; device
kernels cast explicitly. Every float32 matrix product and convolution runs
at HIGHEST precision (full float32, never TF32): the window solver gathers
state through one-hot products, which are exact only at full precision.
Relaxing this is a measured decision per op (ROADMAP Queue 1 item 3).
"""

import os as _os

import jax as _jax

try:  # must happen before any array is created; harmless if already set
    _jax.config.update("jax_enable_x64", True)
except Exception:  # pragma: no cover
    pass
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

# <repo>/.jax_cache: inside the checkout (gitignored) and at a fixed path,
# because the path is part of what the persistent cache is keyed on
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache (call BEFORE the first jit)
    and return its directory: `JAX_COMPILATION_CACHE_DIR` when set, else the
    fixed in-checkout `.jax_cache`. min_compile_time_secs=0.5 keeps trivial
    programs out of the cache."""
    cache_dir = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR
    _jax.config.update("jax_compilation_cache_dir", cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
