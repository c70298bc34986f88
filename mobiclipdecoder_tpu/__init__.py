"""mobiclipdecoder_tpu: a GPU Mobiclip A/V decode engine in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of the
reference Gericom/MobiclipDecoder (C#): Mobiclip video decode (DS MODS and
3DS Moflex profiles, Wii MOC5), container demuxing (Moflex/MODS/MOC5/VX2),
audio codecs (IMA ADPCM, Sx, FastAudio), an encoder, and batch corpus
transcoding via GOP sharding.
"""
import os

__version__ = "0.1.0"

#: the persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this package points JAX's persistent compilation
    cache at, or None when JAX_COMPILATION_CACHE_DIR is set (JAX then reads
    it itself and nothing is set here)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def _enable_persistent_cache() -> None:
    """One cache for every entry point (CLI, library, smoke check): each
    (geometry, bucket) executor shape compiles once per cache."""
    cache = compile_cache_dir()
    if cache is None:
        return
    try:
        import jax
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except ImportError:   # jax absent: the oracle paths still work
        pass


_enable_persistent_cache()
