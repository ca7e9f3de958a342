"""The port's test files share one thread policy: a test module imports
``one_thread`` (``from torch_threads import one_thread  # noqa: F401``) and
its tests run with one intra-op thread, since the tier-1 run's pytest
workers share the CPU.

Two more fixtures serve the modules that compare against the JAX package
(where JAX is installed, which it is not on the card's machine); a module
takes them by importing them beside ``one_thread``, and each holds only
while that module's tests run, so the JAX package's own test modules see
the package as it is:

- ``jax_fg_lut_once``: the JAX package's FG LUT
  (``dreammat_tpu.ops.envmap.compute_fg_lut``, 1.6-4.8 s of eager XLA ops
  a call here, once for every JAX material) computed once a process per
  argument set: the same array each time, as JAX arrays are immutable;
- ``jax_compiles_cached``: every XLA compile kept in the JAX package's
  persistent compilation cache (``dreammat_tpu/__init__.py`` keeps only
  those of 2 s or more), so a pytest worker loads what another worker of
  the same run compiled: the parity tests' references are the same small
  programs in many files (the same executable, so the same numbers)."""

import pytest
import torch


_JAX_FG_LUTS = {}


@pytest.fixture(scope="module", autouse=True)
def jax_fg_lut_once():
    """The JAX package's FG LUT computed once a process per argument set
    while the module's tests run (kept only off a trace)."""
    try:
        import jax
        from dreammat_tpu.ops import envmap
    except ImportError:
        yield
        return
    compute = envmap.compute_fg_lut

    def once(res: int = 256, n_samples: int = 512):
        if (res, n_samples) in _JAX_FG_LUTS:
            return _JAX_FG_LUTS[res, n_samples]
        lut = compute(res, n_samples)
        if not isinstance(lut, jax.core.Tracer):
            _JAX_FG_LUTS[res, n_samples] = lut
        return lut

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(envmap, "compute_fg_lut", once)
        yield


@pytest.fixture(scope="module", autouse=True)
def jax_compiles_cached():
    """Every XLA compile kept in the JAX package's persistent compilation
    cache while the module's tests run (not under
    ``DREAMMAT_NO_COMPILE_CACHE=1``, which sets no cache directory)."""
    try:
        import jax
        import dreammat_tpu  # noqa: F401  (sets the compilation cache directory)
    except ImportError:
        yield
        return
    if not jax.config.jax_compilation_cache_dir:
        yield
        return
    key = "jax_persistent_cache_min_compile_time_secs"
    before = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    try:
        yield
    finally:
        jax.config.update(key, before)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
