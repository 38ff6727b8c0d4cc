"""Layer I/II device compute path, batched over frames.

Everything the reference does per-frame sequentially (encode.c L1/L2
paths + psy.c) becomes one jitted graph over the whole clip:

  filterbank: the same shift-batched windowed matmul as Layer III
    (jaxdsp.subband_granules reformulation of encode.c:287-409);
  psy model 2 (psy.c): Hann window + rfft over all analysis windows at
    once, unpredictability from shifted spectra, partition sums and the
    63x63 spreading convolution as matmuls, 32-subband SNR
    translation with strided min/sum segments;
  scale factors (encode.c:536-557): a digitize over the descending
    multiple[] table;
  scfsi transmission classes (encode.c:626-679): branchless select;
  a*x+b quantization + MSB inversion + 3-sample grouping
    (encode.c:1264-1431): gathers over the allocation tables.

The only sequential piece -- the greedy min-MNR bit allocation -- has
no cross-frame state (unlike Layer III's reservoir), so the host runs
it exactly, vectorized over all frames in lockstep (see
mp3tpu.encoder.encode_layer12_fast).

Fast-path deviations from the oracle (mp3tpu/numpy_ref): float32 DSP
and jnp.fft instead of the reference's float32 split-radix (same
precision class, different rounding), so allocations can differ on
threshold ties; streams remain valid and decoded quality equal.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..numpy_ref import psy12 as psy12_ref
from ..tables import dsp as T
from ..tables import layer12 as L
from ..tables import mpeg
from . import exact_matmuls

F32 = jnp.float32


@exact_matmuls
def subband_frames(blocks, ngroups, dtype=F32):
    """Polyphase analysis over whole frames.

    blocks: (F, spf) scaled samples (x/32768).
    Returns (F, ngroups, 12, 32) subband samples.
    """
    from . import jaxdsp

    nf = blocks.shape[0]
    flat = jnp.concatenate([jnp.zeros(512, dtype),
                            blocks.reshape(-1).astype(dtype)])
    nshift = nf * ngroups * 12
    # slice-based sliding windows (see jaxdsp.sliding_shift_windows)
    W = jaxdsp.sliding_shift_windows(flat, nshift, dtype)
    v = W * jnp.asarray(jaxdsp._ENWINDOW_REV, dtype)[None, :]
    y = v.reshape(-1, 8, 64).sum(axis=1)
    s = y @ jnp.asarray(jaxdsp._ANA_FILTER_REV.T, dtype)
    return s.reshape(nf, ngroups, 12, 32)


def _psy_constants(sfreq_hz):
    """Partition/spreading constants from the oracle's init (exact
    float64/float32 replication lives there; the device path uses the
    same numeric tables)."""
    P = psy12_ref._init_params(float(sfreq_hz))
    part = P["partition"]
    onehot = np.zeros((psy12_ref.CBANDS, psy12_ref.HBLKSIZE), np.float32)
    onehot[part, np.arange(psy12_ref.HBLKSIZE)] = 1.0
    kk = (P["cbval"].astype(np.float64) + 0.5).astype(np.int64)
    return dict(
        onehot=onehot, s=P["s"].astype(np.float32),
        tmn=P["tmn"].astype(np.float32),
        bmax=psy12_ref._BMAX[kk].astype(np.float32),
        denom=(P["rnorm"].astype(np.float64) * P["numlines"]
               ).astype(np.float32),
        absthr=P["absthr"].astype(np.float32),
        part=part.astype(np.int32))


@exact_matmuls
def psy_snr32(windows, layer, consts):
    """Model-2 SNR for a batch of 1024-sample analysis windows.

    windows: (NW, 1024) float32 (raw int16-valued samples).
    Returns (NW, 32) SNR in dB; for layer 2 the caller maxes window
    pairs.
    """
    i = jnp.arange(1024, dtype=jnp.float64)
    hann = (0.5 * (1 - jnp.cos(2.0 * mpeg.REF_PI * (i - 0.5) / 1024))
            ).astype(F32)
    spec = jnp.fft.rfft(windows * hann[None, :])
    re, im = jnp.real(spec).astype(F32), jnp.imag(spec).astype(F32)
    energy = re * re + im * im
    # interior-line floor like enphinew (subs.c:67-80)
    interior = (jnp.arange(513) > 0) & (jnp.arange(513) < 512)
    floored = interior[None, :] & (energy < 0.0005)
    energy = jnp.where(floored, 0.0005, energy)
    phi = jnp.where(floored, 0.0, jnp.arctan2(-im, re))

    r = jnp.sqrt(energy)
    rz = jnp.zeros((1,) + r.shape[1:], r.dtype)
    r1 = jnp.concatenate([rz, r[:-1]])
    r2 = jnp.concatenate([rz, rz, r[:-2]])
    p1 = jnp.concatenate([rz, phi[:-1]])
    p2 = jnp.concatenate([rz, rz, phi[:-2]])
    rp = 2.0 * r1 - r2
    pp = 2.0 * p1 - p2
    t1 = r * jnp.cos(phi) - rp * jnp.cos(pp)
    t2 = r * jnp.sin(phi) - rp * jnp.sin(pp)
    t3 = r + jnp.abs(rp)
    c = jnp.where(t3 != 0.0, jnp.sqrt(t1 * t1 + t2 * t2)
                  / jnp.where(t3 == 0, 1, t3), 0.0)

    onehot = jnp.asarray(consts["onehot"])          # (63, 513)
    ge = energy @ onehot.T                          # (NW, 63)
    gc = (energy * c) @ onehot.T
    s = jnp.asarray(consts["s"])                    # (63, 63) target,src
    ecb = ge @ s.T
    cb = gc @ s.T
    cbn = jnp.clip(jnp.where(ecb != 0.0, cb / jnp.where(ecb == 0, 1, ecb),
                             0.0), 0.05, 0.5)
    tb = -0.434294482 * jnp.log(cbn) - 0.301029996
    bc = jnp.maximum(consts["tmn"][None, :] * tb + 5.5 * (1.0 - tb),
                     consts["bmax"][None, :])
    bc = jnp.exp(-bc * mpeg.LN_TO_LOG10)
    denom = jnp.asarray(consts["denom"])
    nb = jnp.where(denom[None, :] != 0.0,
                   ecb * bc / jnp.where(denom == 0, 1, denom)[None, :], 0.0)

    temp1 = jnp.maximum(nb[:, consts["part"]], consts["absthr"][None, :])
    if layer == 1:
        lthr_prev = jnp.concatenate(
            [jnp.full((1, 513), 60802371420160.0, temp1.dtype),
             32.0 * temp1[:-1]])
        fthr = jnp.minimum(temp1, lthr_prev)
        fthr = jnp.maximum(temp1 * 0.00316, fthr)
    else:
        fthr = temp1

    # 32-subband translation (psy.c:369-387): bands 0..12 use min
    # threshold, 13..31 sum thresholds; 17-line windows, stride 16
    idx = (16 * jnp.arange(32))[:, None] + jnp.arange(17)[None, :]
    seg_t = fthr[:, idx]                            # (NW, 32, 17)
    seg_e = energy[:, idx]
    lowband = (jnp.arange(32) < 13)[None, :]
    thr = jnp.where(lowband, seg_t.min(axis=2) * 17.0, seg_t.sum(axis=2))
    v = seg_e.sum(axis=2) / thr
    return 4.342944819 * jnp.log(v)


def psy_windows(stream, nframes, layer):
    """Analysis windows for the model-2 head (psy.c:258-267 savebuf
    slide as pure indexing; layer 1 windows stream[384f-640:+1024),
    layer 2 two windows per frame at 1152f+576i-480)."""
    pad = 1024
    xp = jnp.concatenate([jnp.zeros(pad, F32), stream.astype(F32)])
    if layer == 1:
        starts = 384 * jnp.arange(nframes) - 640
    else:
        f = jnp.repeat(jnp.arange(nframes), 2)
        i = jnp.tile(jnp.arange(2), nframes)
        starts = 1152 * f + 576 * i - 480
    idx = pad + starts[:, None] + jnp.arange(1024)[None, :]
    return xp[jnp.clip(idx, 0, xp.shape[0] - 1)]


@partial(jax.jit, static_argnames=("layer", "table", "sblimit", "nch",
                                   "nframes", "sfreq_hz"))
def analyze_frames(pcm, fb_stream, layer, table, sblimit, nch, nframes,
                   sfreq_hz):
    """Device analysis for the whole clip: filterbank + psy + scale
    factors + scfsi (+ joint combine).

    pcm: (nch, N) raw int16-valued float32 (psy input stream).
    fb_stream: (nch, N) filterbank input stream (layer 1: 64-sample
      delayed copy; layer 2: same as pcm).
    Returns device dict.
    """
    ngroups = 1 if layer == 1 else 3
    spf = 384 if layer == 1 else 1152
    consts = _psy_constants(sfreq_hz)
    out = {}
    sbs = []
    snrs = []
    for ch in range(nch):
        sb = subband_frames(fb_stream[ch].reshape(nframes, spf) / 32768.0,
                            ngroups)
        win = psy_windows(pcm[ch], nframes, layer)
        snr = psy_snr32(win, layer, consts)
        if layer == 2:
            snr = jnp.maximum(snr[0::2], snr[1::2])
        sbs.append(sb)
        snrs.append(snr)
    sb = jnp.stack(sbs)                    # (nch, F, G, 12, 32)
    out["snr"] = jnp.stack(snrs)           # (nch, F, 32)
    out["sb"] = sb
    scalar = scale_factors(sb.reshape(-1, ngroups, 12, 32), sblimit)
    scalar = scalar.reshape(nch, nframes, ngroups, 32)
    if layer == 2:
        scfsi, scalar2 = scfsi_pattern(
            scalar.reshape(-1, 3, 32))
        out["scfsi"] = scfsi.reshape(nch, nframes, 32)
        scalar = scalar2.reshape(nch, nframes, 3, 32)
    out["scalar"] = scalar
    if nch == 2:
        j_sample = 0.5 * (sb[0] + sb[1])
        j_scale = scale_factors(j_sample, sblimit)
        out["j_sample"] = j_sample
        out["j_scale"] = j_scale
    return out


def scale_factors(sb, sblimit):
    """encode.c:536-557 on device: (F, G, 12, 32) -> (F, G, 32) idx."""
    s = jnp.abs(sb).max(axis=-2)
    mult = jnp.asarray(mpeg.MULTIPLE[:63])
    idx = jnp.searchsorted(-mult, -s, side="right") - 1
    idx = jnp.clip(idx, 0, 62)
    over = jnp.arange(32)[None, None, :] >= sblimit
    return jnp.where(over, 63, idx)


def scfsi_pattern(scalar):
    """encode.c:626-679 branchless: scalar (F, 3, 32) int ->
    (scfsi (F, 32), new_scalar (F, 3, 32))."""
    d0 = scalar[:, 0] - scalar[:, 1]
    d1 = scalar[:, 1] - scalar[:, 2]

    def cls(d):
        return jnp.where(d <= -3, 0,
               jnp.where(d < 0, 1,
               jnp.where(d == 0, 2,
               jnp.where(d < 3, 3, 4))))

    pat = jnp.asarray(L.SCFSI_PATTERN)[cls(d0), cls(d1)]   # (F, 32)
    s0, s1, s2 = scalar[:, 0], scalar[:, 1], scalar[:, 2]
    scfsi = jnp.select(
        [pat == 0x123, (pat == 0x122) | (pat == 0x133),
         pat == 0x113],
        [0, 3, 1], 2)
    n0 = jnp.select([pat == 0x222, pat == 0x333, pat == 0x444],
                    [s1, s2, jnp.minimum(s0, s2)], s0)
    n1 = jnp.select(
        [pat == 0x122, pat == 0x133, pat == 0x113, pat == 0x111,
         pat == 0x222, pat == 0x333, pat == 0x444],
        [s1, s2, s0, s0, s1, s2, jnp.minimum(s0, s2)], s1)
    n2 = jnp.select(
        [pat == 0x122, pat == 0x111, pat == 0x222, pat == 0x333,
         pat == 0x444],
        [s1, s0, s1, s2, jnp.minimum(s0, s2)], s2)
    return scfsi, jnp.stack([n0, n1, n2], axis=1)


def _apply_quant(d, a, b, nbits):
    """Shared core: dq = a*d + b, MSB inversion, truncate to nbits
    (encode.c:1250-1258 / 1295-1316)."""
    dq = d * a + b
    sig = dq >= 0
    dq = jnp.where(sig, dq, dq + 1.0)
    scale = jnp.exp2(nbits.astype(d.dtype))
    v = jnp.floor(dq * scale).astype(jnp.int32)
    return v | jnp.where(sig, jnp.left_shift(1, nbits), 0)


def quantize_l1(sb, scalar, bit_alloc):
    """Layer I quantization (encode.c:1205-1259).

    sb: (F, 1, 12, 32); scalar: (F, 1, 32); bit_alloc: (F, 32).
    Returns codes (F, 1, 12, 32) (junk where bit_alloc == 0).
    """
    d = sb / jnp.asarray(mpeg.MULTIPLE)[scalar][:, :, None, :]
    ba = jnp.maximum(bit_alloc, 1)[:, None, None, :]
    a = jnp.asarray(L.QUANT_A_L1)[ba - 1]
    b = jnp.asarray(L.QUANT_B_L1)[ba - 1]
    return _apply_quant(d, a, b, ba)


def quantize_l2(sb, scalar, bit_alloc, table):
    """Layer II quantization (encode.c:1264-1321).

    sb: (F, 3, 12, 32); scalar: (F, 3, 32); bit_alloc: (F, 32).
    Returns codes (F, 3, 12, 32) (junk where bit_alloc == 0).
    """
    alloc = L.ALLOC[table]
    d = sb / jnp.asarray(mpeg.MULTIPLE)[scalar][:, :, None, :]
    cols = jnp.arange(32)[None, :]
    qnt = jnp.asarray(alloc["quant"])[cols, bit_alloc]       # (F, 32)
    steps = jnp.asarray(alloc["steps"])[cols, bit_alloc]
    a = jnp.asarray(L.QUANT_A)[qnt][:, None, None, :]
    b = jnp.asarray(L.QUANT_B)[qnt][:, None, None, :]
    # n: smallest n with 2^n >= steps, minus 1 (encode.c:1299-1311);
    # L2 steps are 2^k - 1 or 3/5/9, so ceil(log2(steps)) - 1
    steps = jnp.maximum(steps, 2)
    nbits = (jnp.ceil(jnp.log2(steps.astype(jnp.float64)))
             .astype(jnp.int32) - 1)[:, None, None, :]
    return _apply_quant(d, a, b, nbits)
