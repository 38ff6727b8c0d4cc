"""Device-side reservoir budget scan (reservoir.c:101-134 policy).

The C scan (native/mp3bits.cpp mp3resv_scan, mode 0) runs on the host
between the demand and final device passes -- which costs a device
sync.  This is the same recurrence as a `lax.scan` over frames: the carry is one
int32 scalar (the reservoir level), the per-frame body unrolls the
mode_gr x nch granule updates.  With it, the whole encode pipeline
(analyze+demand -> budget scan -> final encode+pack) runs as one
uninterrupted device program chain with a single host sync at the end.

Semantics notes:
  - all divisions in the C scan act on non-negative values (the
    reservoir level provably never goes negative in mode 0: granted
    budgets never draw more than the level covers), so Python floor
    division matches C truncation;
  - pe enters as float64 (exact under the x64 test config, downcast to
    f32 on accelerators -- a knife-edge trunc(pe*3.1) may then differ
    from the C scan by one bit of budget; feasibility is unaffected
    because the realized p23 chain is still guard-validated).
Exactness vs the native scan is locked by tests/test_jaxresv.py.
"""
from functools import partial

import jax
import jax.numpy as jnp


def _scan_core(pe, demand, size0, mean_bits, resv_max, mode_gr, nch,
               delta, valid=None):
    R = mode_gr * nch
    mean = mean_bits // nch
    max_bits = min(mean, 4095)
    pe = pe.astype(jnp.float64)
    demand = demand.astype(jnp.int32)
    if valid is None:
        valid = jnp.ones(pe.shape[0], bool)

    def frame(size, xs):
        pe_f, dem_f, val_f = xs
        size_in = size
        budgets = []
        for r in range(R):
            if resv_max == 0:
                b = jnp.int32(max_bits)
            else:
                more_bits = jnp.trunc(pe_f[r] * 3.1 - mean) \
                    .astype(jnp.int32)
                frac = (size * 6) // 10
                add = jnp.where(more_bits > 100,
                                jnp.minimum(frac, more_bits), 0)
                over = size - (resv_max * 8) // 10 - add
                add = add + jnp.maximum(over, 0)
                b = jnp.minimum(max_bits + add, 4095)
            used = jnp.where(dem_f[r] < b, dem_f[r],
                             jnp.maximum(b - delta, 0))
            size = size + mean - used
            budgets.append(b)
        if nch == 2 and (mean_bits % 2) == 1:
            size = size + 1
        size = jnp.minimum(size, resv_max)
        size = size - size % 8
        # padded (invalid) frames pass the reservoir level through
        # untouched -- they exist only to fill a shape bucket
        size = jnp.where(val_f, size, size_in)
        return size, jnp.stack(budgets)

    size_out, budgets = jax.lax.scan(frame, jnp.asarray(size0, jnp.int32),
                                     (pe, demand, valid))
    return budgets, size_out


@partial(jax.jit, static_argnames=("mean_bits", "resv_max", "mode_gr",
                                   "nch", "delta"))
def scan_budgets(pe, demand, size0, mean_bits, resv_max, mode_gr, nch,
                 delta, valid=None):
    """pe, demand: (F, R) granule-major (r = gr*nch + ch) float/int32.
    size0: () int32 carried reservoir level (streaming windows).
    valid: optional (F,) bool -- False frames are bucket padding and
    leave the reservoir level unchanged (lets n_real stay a TRACED
    value so one compiled program serves every clip length in a shape
    bucket).  Returns (budgets (F, R) int32, size_out ()).
    """
    return _scan_core(pe, demand, size0, mean_bits, resv_max, mode_gr,
                      nch, delta, valid=valid)


@partial(jax.jit, static_argnames=("mean_bits", "resv_max", "mode_gr",
                                   "nch", "delta"))
def scan_budgets_batched(pe, demand, size0, mean_bits, resv_max,
                         mode_gr, nch, delta):
    """Clip-batched scan for the corpus path: pe/demand (B, F, R),
    size0 (B,).  One vmapped lax.scan dispatch instead of B serial
    per-clip dispatches (serial per-clip scans made wider lanes barely
    pay)."""
    return jax.vmap(
        lambda p, d, s: _scan_core(p, d, s, mean_bits, resv_max,
                                   mode_gr, nch, delta))(pe, demand,
                                                         size0)


def granule_major(x, nch, mode_gr):
    """(nch, G) -> (F, R) with r = gr*nch + ch (the scan's order)."""
    G = x.shape[1]
    F = G // mode_gr
    return x.reshape(nch, F, mode_gr).transpose(1, 2, 0) \
        .reshape(F, mode_gr * nch)


def from_granule_major(x, nch, mode_gr):
    """(F, R) -> (nch, G)."""
    F = x.shape[0]
    return x.reshape(F, mode_gr, nch).transpose(2, 0, 1) \
        .reshape(nch, F * mode_gr)
