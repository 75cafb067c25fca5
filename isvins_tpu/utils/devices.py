"""Host-CPU placement for the float64 support computations."""

from __future__ import annotations

import contextlib

import jax


def host_cpu():
    """Context that places new arrays and jitted calls on the host CPU
    backend; a no-op when the CPU is already the default backend.

    The float64 support math (init BA and alignment, marginalization
    eigendecompositions, triangulation, epipolar RANSAC, PnP verification)
    runs there while the float32 steady-state work stays on the accelerator.
    Whether it pays on the H100, which runs float64 natively, is unmeasured
    (ROADMAP Queue 1 item 4). The CPU backend must be available: do not set
    JAX_PLATFORMS to the accelerator alone."""
    if jax.default_backend() == "cpu":
        return contextlib.nullcontext()
    return jax.default_device(jax.devices("cpu")[0])
