"""Launch-time policy: engine mode resolution, the compile cache, one card
per worker process, and the compiled-kernel checks that need a GPU."""
import os

import pytest

import mobiclipdecoder_tpu
from mobiclipdecoder_tpu.parallel.distributed import pin_worker_card

pytest.importorskip("jax")
from mobiclipdecoder_tpu.ops.vmem_engine import resolve_interpret  # noqa


@pytest.mark.parametrize("backend,platforms,want", [
    ("gpu", "", False),
    ("gpu", "cuda", False),
    ("cpu", "cpu", True),
])
def test_interpret_resolution(backend, platforms, want):
    assert resolve_interpret(None, backend, platforms) is want


@pytest.mark.parametrize("backend,platforms", [
    ("cpu", ""),            # fell back to the CPU: refuse, don't interpret
    ("rocm", ""),
    ("rocm", "rocm"),
])
def test_interpret_resolution_raises_off_cpu(backend, platforms):
    with pytest.raises(RuntimeError, match="--engine oracle"):
        resolve_interpret(None, backend, platforms)


def test_interpret_explicit_choice_wins():
    assert resolve_interpret(True, "rocm", "") is True
    assert resolve_interpret(False, "cpu", "cpu") is False


def test_compile_cache_dir_honours_env():
    assert mobiclipdecoder_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None
    default = mobiclipdecoder_tpu.compile_cache_dir({})
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(mobiclipdecoder_tpu.__file__)))
    assert default == os.path.join(root, ".jax_cache")


def test_compile_cache_configured_once():
    """The package import left JAX pointing at the env var's directory
    when it is set, else at <checkout>/.jax_cache."""
    import jax
    want = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or mobiclipdecoder_tpu.DEFAULT_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("env,n_cards,worker,want", [
    ({"CUDA_VISIBLE_DEVICES": "0,1,2,3"}, None, 2, "2"),
    ({"CUDA_VISIBLE_DEVICES": "0,1,2,3"}, None, 5, "1"),
    ({"CUDA_VISIBLE_DEVICES": "4,6"}, None, 3, "6"),
    ({"CUDA_VISIBLE_DEVICES": "3"}, None, 0, "3"),     # already pinned
    ({}, 4, 6, "2"),                                   # every card listed
    ({}, 0, 1, None),                                  # no card at all
])
def test_worker_card_pinning(env, n_cards, worker, want):
    env = dict(env)
    assert pin_worker_card(worker, env, n_cards) == want
    if want is not None:
        assert env["CUDA_VISIBLE_DEVICES"] == want


@pytest.fixture
def gpu():
    """A GPU backend, decided when the test runs (never at import)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; python chip_smoke.py runs these checks "
                    "on the card")


@pytest.mark.gpu
def test_compiled_executor_batch_matches_oracle(gpu):
    import chip_smoke
    with chip_smoke._pool() as pool:
        chip_smoke.phase_batch(0, pool)


@pytest.mark.gpu
def test_compiled_executor_format_surface(gpu):
    import chip_smoke
    with chip_smoke._pool() as pool:
        chip_smoke.phase_surface(0, pool)
