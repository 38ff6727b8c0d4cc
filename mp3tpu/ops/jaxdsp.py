"""DSP front-end: polyphase analysis + MDCT as batched matmuls over
the granule axis.

Reformulation (cf. SURVEY.md section 2.1 and the oracle in
mp3tpu/numpy_ref/dsp.py): all ring-buffer state becomes shifted slices
of the (G, 576) sample-block tensor, so every granule is independent
and the whole front-end is three einsums:

  windowing:  Z[t, i] = x[32 t + 31 - i] * enwindow[i]
  filterbank: S = fold(Z) @ ANA_FILTER.T        (shift-batched matmul)
  MDCT:       X = (win * in36) @ COS_L.T        (+ alias butterflies,
                                                 a fixed linear map)

Block-type switching computes both the long and short transforms and
selects per granule -- branchless, XLA-friendly.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import dsp as T
from . import exact_matmuls

_SIGN = np.ones((18, 32))
_SIGN[1::2, 1::2] = -1.0


def sliding_shift_windows(flat, nshift, dtype):
    """(nshift, 512) windows W[t, j] = flat[32 (t+1) + j] built from 16
    strided reshapes instead of an arbitrary-index gather; slices are
    pure layout ops.

    The reference's window is z[t, i] = flat[512 + 32 t + 31 - i]
    (encode.c:287-315); with j = 511 - i that is exactly W[t, j], so
    callers fold the index reversal into their constants.
    """
    cols = [jax.lax.dynamic_slice(flat, (32 + 32 * k,), (32 * nshift,))
            .reshape(nshift, 32) for k in range(16)]
    return jnp.concatenate(cols, axis=1).astype(dtype)


# constants with the j = 511 - i reversal folded in
_ENWINDOW_REV = T.ENWINDOW[::-1].copy()
_ANA_FILTER_REV = T.ANA_FILTER[:, ::-1].copy()


@exact_matmuls
def subband_granules(blocks, prev_tail, dtype=jnp.float32):
    """Polyphase analysis for a batch of granules.

    blocks: (G, 576) scaled samples (x/32768), granule-major.
    prev_tail: (512,) the 512 samples preceding blocks[0] (zeros at
      stream start / halo from the neighbor shard).
    Returns (G, 18, 32) subband samples.
    """
    G = blocks.shape[0]
    flat = jnp.concatenate([prev_tail.astype(dtype), blocks.reshape(-1).astype(dtype)])
    W = sliding_shift_windows(flat, 18 * G, dtype)
    v = W * jnp.asarray(_ENWINDOW_REV, dtype)[None, :]
    # y[m] = sum_q v[64 q + m]; the fold's 64->32 matrix reads it in
    # reversed order, folded into _ANA_FILTER_REV
    y = v.reshape(-1, 8, 64).sum(axis=1)
    # full f32 (exact_matmuls): a filterbank feeding a 16-bit-depth
    # quantizer needs more than a reduced-precision matmul's mantissa
    s = y @ jnp.asarray(_ANA_FILTER_REV.T, dtype)
    return s.reshape(G, 18, 32)


def _alias_matrix():
    """Aliasing butterflies (mdct.c:83-91) as one (576, 576) sparse
    linear map on the per-granule (32 band, 18 line) spectrum."""
    A = np.eye(576)
    for band in range(31):
        for k in range(8):
            i_lo = band * 18 + (17 - k)
            i_hi = (band + 1) * 18 + k
            # bu = lo*cs + hi*ca ; bd = hi*cs - lo*ca
            rl = A[i_lo].copy()
            rh = A[i_hi].copy()
            A[i_lo] = rl * T.ALIAS_CS[k] + rh * T.ALIAS_CA[k]
            A[i_hi] = rh * T.ALIAS_CS[k] - rl * T.ALIAS_CA[k]
    return A


_ALIAS = _alias_matrix()


def _short_basis():
    """(36, 18) combined map: in36 -> interleaved short MDCT output."""
    B = np.zeros((36, 18))
    for l in range(3):
        for m in range(6):
            for k in range(12):
                B[k + 6 * l + 6, 3 * m + l] += T.MDCT_WIN[2][k] * T.COS_S[m, k]
    return B


_BASIS_LONG = {b: (T.MDCT_WIN[b][:, None] * T.COS_L.T) for b in (0, 1, 3)}
_BASIS_SHORT = _short_basis()


@exact_matmuls
def mdct_granules(sb, sb_prev_last, block_type, dtype=jnp.float32):
    """Batched MDCT over granules.

    sb: (G, 18, 32) current subband samples.
    sb_prev_last: (18, 32) the granule preceding sb[0] (zeros/halo).
    block_type: (G,) int32.
    Returns xr (G, 576) in reference layout.
    """
    G = sb.shape[0]
    sbf = sb.astype(dtype) * jnp.asarray(_SIGN, dtype)[None]
    prevf = jnp.concatenate([
        (sb_prev_last.astype(dtype) * jnp.asarray(_SIGN, dtype))[None],
        sbf[:-1]], axis=0)
    mdct_in = jnp.concatenate([prevf, sbf], axis=1)      # (G, 36, 32)
    x = mdct_in.transpose(0, 2, 1)                        # (G, 32, 36)

    outs = []
    for b in (0, 1, 3):
        outs.append(x @ jnp.asarray(_BASIS_LONG[b], dtype))
    out_short = x @ jnp.asarray(_BASIS_SHORT, dtype)

    bt = block_type[:, None, None]
    out = jnp.where(bt == 0, outs[0],
          jnp.where(bt == 1, outs[1],
          jnp.where(bt == 3, outs[2], out_short)))    # (G, 32, 18)
    xr = out.reshape(G, 576)
    # alias reduction only for non-short
    xr_alias = xr @ jnp.asarray(_ALIAS.T, dtype)
    return jnp.where((block_type == 2)[:, None], xr, xr_alias)
