"""Device compute ops: psychoacoustics, filterbank/MDCT, rate loop,
reservoir scan and Huffman emission, as batched JAX programs."""
import functools


def exact_matmuls(fn):
    """Trace ``fn`` with every float matmul at HIGHEST precision.

    A GPU runs DEFAULT-precision f32 matmuls in TF32 (a 10-bit
    mantissa).  Here the dots compute spectra, band energies, line
    gains and bit counts that feed integer decisions (stepsizes,
    scalefactors, table choices), so none may run below full f32.
    The scope is created per call: one config context object must not
    be entered by two threads that trace at the same time."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        import jax

        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
