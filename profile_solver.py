"""Device time of each stage of the product-width window solve, read from a
jax.profiler trace of the real jitted solve.

    python profile_solver.py [--solves 5] [--out chiprun_out/solver_trace]

The stages are the solver's named scopes (solver/window.py): imu_factors,
proj_factors, lm_linear_step and, inside it, schur_correction. Each device
event of the trace carries the name of the HLO instruction it ran (or, for
a kernel XLA launched inside a CUDA graph, the kernel name, which for a
fusion is the instruction name with '_' for '.'); the compiled program's
op_name metadata says which scope that instruction came from. Library
kernels inside a CUDA graph (cuBLAS) cannot be traced back to an
instruction: run with XLA_FLAGS=--xla_gpu_enable_command_buffer= for a full
attribution. Prints the device, the chained per-solve time, the device busy
time per solve and each stage's device time per solve ('other' is what no
scope claims). Run it on the GPU for device numbers; on the CPU backend it
only checks the reduction.
"""

import argparse
import glob
import json
import re
import time
from collections import defaultdict

import jax
import jax.numpy as jnp

SCOPES = ("imu_factors", "proj_factors", "lm_linear_step", "schur_correction")


def op_names(hlo_text):
    """{instruction name: op_name metadata} of a compiled HLO module."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name="([^"]*)"')
    out = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def device_events(xplane_path):
    """[(instruction, duration_ns, start_ns)] of the kernels that ran on
    devices (on the CPU backend, of the XLA ops on the host's compute
    threads); `instruction` is the hlo_op stat, or the kernel name for
    kernels launched inside a CUDA graph."""
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in pd.planes if p.name == "/host:CPU"]
    out = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op == "command_buffer":
                    op = ev.name
                if op:
                    out.append((op, ev.duration_ns, ev.start_ns))
    return out


def stage_times(hlo_text, events, scopes=SCOPES):
    """Device ns per scope (an event counts toward every scope on its
    op_name path), plus 'busy' (union of the event intervals) and 'all'."""
    names = op_names(hlo_text)
    names.update({k.replace(".", "_"): v for k, v in names.items()})
    t = defaultdict(float)
    for op, dur, _ in events:
        path = names.get(op, "")
        t["all"] += dur
        hit = [s for s in scopes if f"/{s}/" in path or path.endswith(f"/{s}")]
        for s in hit:
            t[s] += dur
        if not hit:
            t["other"] += dur
    busy, end = 0.0, -1.0
    for _, dur, start in sorted(events, key=lambda e: e[2]):
        lo, hi = max(start, end), start + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    t["busy"] = busy
    return dict(t)


def solve_chain(dims, args, solve_fn):
    """jit(run)(state, n): n data-dependent solves (chained timing: one
    dispatch, one scalar pull). A small index-derived perturbation between
    links keeps the LM convergence early-out from trivializing later
    links."""
    state, imu, proj, priors, G, psi = args

    @jax.jit
    def run(st, n):
        def link(i, s):
            pert = (0.02 * jnp.cos(i + jnp.arange(s.P.shape[-2])[:, None])).astype(s.P.dtype)
            return solve_fn(s._replace(P=s.P + pert), imu, proj, priors, G, psi, dims, 10)[0]
        return jax.lax.fori_loop(0, n, link, st).P.sum()

    return run


def chained_ms(run, st, ns=(1, 11), reps=3):
    """Per-solve ms: the marginal time between chain lengths ns."""
    best = {}
    for n in ns:
        float(run(st, n))  # compile + warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(run(st, n))
            ts.append(time.perf_counter() - t0)
        best[n] = min(ts)
    return (best[ns[1]] - best[ns[0]]) / (ns[1] - ns[0]) * 1e3


def profile(run, st, n_solves, out_dir):
    """Stage ms per solve of `run` from one traced call of n_solves."""
    hlo = run.lower(st, n_solves).compile().as_text()
    float(run(st, n_solves))
    with jax.profiler.trace(out_dir):
        float(run(st, n_solves))
    path = sorted(glob.glob(f"{out_dir}/**/*.xplane.pb", recursive=True))[-1]
    t = stage_times(hlo, device_events(path))
    return {k: v / n_solves / 1e6 for k, v in t.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/solver_trace")
    a = ap.parse_args()

    import isvins_tpu
    from isvins_tpu.solver import reference as ref
    from isvins_tpu.solver.window import solve_window

    isvins_tpu.enable_compile_cache()
    dev = jax.devices()[0]
    args = ref.product_problem()
    run = solve_chain(ref.PRODUCT_DIMS, args, solve_window.__wrapped__)
    res = {"device": dev.device_kind, "platform": dev.platform,
           "chained_ms_per_solve": chained_ms(run, args[0]),
           "stage_ms_per_solve": profile(run, args[0], a.solves, a.out)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
