"""Process-level behaviour: the persistent compile cache's directory and
chip_smoke.py's refusal to run without a GPU. Each case runs in a fresh
interpreter, so no JAX configuration leaks into the other tests."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    e = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    e.update(JAX_PLATFORMS="cpu", **env)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


_CACHE = ("import isvins_tpu, jax, json; d = isvins_tpu.enable_compile_cache(); "
          "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))")


def test_compile_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert json.loads(_run(_CACHE, JAX_COMPILATION_CACHE_DIR=want)) == [want, want]


def test_compile_cache_default_is_fixed_in_checkout_path():
    first = json.loads(_run(_CACHE))
    second = json.loads(_run(_CACHE))
    assert first == second
    assert first[0] == os.path.join(REPO, ".jax_cache") == first[1]


def test_chip_smoke_refuses_cpu_backend():
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=e,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not a GPU" in out.stderr


def test_profile_solver_attributes_device_time_to_named_scopes(tmp_path):
    """The trace reduction of profile_solver.py: op_name metadata maps each
    traced kernel to its named scope, and scope times stay within the
    traced total."""
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    import profile_solver as ps

    @jax.jit
    def f(x):
        with jax.named_scope("proj_factors"):
            y = jnp.sin(x) @ x
        with jax.named_scope("lm_linear_step"):
            return jnp.linalg.cholesky(y @ y.T + 300.0 * jnp.eye(300))

    x = jnp.ones((300, 300)) * 0.01
    hlo = f.lower(x).compile().as_text()
    assert any("/proj_factors/" in v for v in ps.op_names(hlo).values())
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    path = next(tmp_path.rglob("*.xplane.pb"))
    t = ps.stage_times(hlo, ps.device_events(str(path)))
    assert t["proj_factors"] > 0 and t["lm_linear_step"] > 0
    assert t["proj_factors"] + t["lm_linear_step"] <= t["all"] + 1e-9
    assert 0 < t["busy"] <= t["all"] + 1e-9
