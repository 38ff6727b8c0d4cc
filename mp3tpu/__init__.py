"""mp3tpu: MPEG-1/2 audio encoder (Layers I-III) on a JAX accelerator.

A from-scratch JAX/XLA re-design of the ISO dist10-lineage reference
encoder (lieff/mp3-enc-bsd): device-side psychoacoustics, filterbank,
MDCT, rate loop and Huffman bit packing; native C++ bitstream
assembly; byte-exact NumPy oracle + decoder for verification.
"""
import os

_CACHE_DONE = False


def compile_cache_dir():
    """Directory of the persistent XLA compilation cache:
    $JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache` at the root
    of the checkout -- a fixed path, so every process finds the
    programs an earlier one stored."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".jax_cache"))


def ensure_compile_cache():
    """Persistent XLA compilation cache: the encoder's fixed-size
    programs compile once per checkout, not once per process.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing here overrides it.  Otherwise the cache goes to
    compile_cache_dir().  Called from the encode entry points AFTER jax
    has picked a backend, and before their first compile: XLA:CPU AOT
    entries are pinned to the host's CPU features and can SIGILL when
    loaded under a different feature detection pass, so the CPU backend
    keeps the in-process cache only."""
    global _CACHE_DONE
    if _CACHE_DONE:
        return
    _CACHE_DONE = True
    import jax

    if jax.default_backend() == "cpu" or os.environ.get(
            "JAX_COMPILATION_CACHE_DIR"):
        return
    path = compile_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only install: in-process cache only
    jax.config.update("jax_compilation_cache_dir", path)
