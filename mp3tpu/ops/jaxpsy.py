"""Psychoacoustic model 2 (Layer III flavour).

Design (vs l3psy.c): everything becomes batched matmuls and elementwise
work over the granule axis:

  - the 1024/256-point real FFTs are DFT matmuls (two (N, N/2+1)
    cos/sin matrices);
  - the unpredictability measure is computed from re/im directly
    (no atan2/cos/sin): the extrapolated spectrum is
    r' * unit(2*phi1 - phi2) with unit() from complex products;
  - partition sums, spreading, and sfb conversion are precomputed
    matrices;
  - the block-type FSM (l3psy.c:647-733) is a 3-state associative scan
    over transition maps, so it shards cleanly;
  - cross-granule state (FFT history, pre-echo nb_1/nb_2, one-granule
    emission delay) is realized by shifting along the granule axis with
    halo rows from the neighbor shard.

Matches the oracle (mp3tpu/numpy_ref/psy.py) up to float32 effects; the
deliberate reference quirks (sparse 44.1k spreading, short path reusing
the long spreading matrix and norm, numlines clobbering for pe) are
kept so quality characteristics are comparable.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import mpeg
from ..tables.psy import CBANDS, CBANDS_S, SBMAX_L, SBMAX_S, psy_params_for_sfreq
from . import exact_matmuls

LN = mpeg.LN_TO_LOG10
SWITCH_PE = 1800.0


@lru_cache(maxsize=None)
def _dft_mats(n):
    k = np.arange(n)[:, None]
    f = np.arange(n // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / n
    return np.cos(ang), -np.sin(ang)  # X = x @ (C + iS), rfft convention


@lru_cache(maxsize=None)
def _hann(n):
    i = np.arange(n)
    return (0.5 * (1 - np.cos(2.0 * mpeg.REF_PI * (i - 0.5) / n))).astype(np.float32)


@lru_cache(maxsize=None)
def _psy_mats(sfreq_hz):
    """Constant matrices for one sample rate."""
    P = psy_params_for_sfreq(sfreq_hz)
    # partition one-hot (513 -> 63) incl. the catch-all partition 0
    part_l = np.zeros((513, CBANDS))
    part_l[np.arange(513), P["partition_l"]] = 1.0
    part_s = np.zeros((129, CBANDS))
    part_s[np.arange(129), P["partition_s"]] = 1.0
    s3 = P["s3_l"]
    if abs(sfreq_hz - 44100.0) < 1:
        s3 = s3 * P["s3_mask"]
    # sfb conversion (63 -> 21): en path sums eb with w1/w2 edge weights
    conv_l = np.zeros((CBANDS, SBMAX_L))
    for sb in range(SBMAX_L):
        bu, bo = P["bu_l"][sb], P["bo_l"][sb]
        conv_l[bu, sb] += P["w1_l"][sb]
        conv_l[bo, sb] += P["w2_l"][sb]
        for b in range(bu + 1, bo):
            conv_l[b, sb] += 1.0
    conv_s = np.zeros((CBANDS, SBMAX_S))
    for sb in range(SBMAX_S):
        bu, bo = P["bu_s"][sb], P["bo_s"][sb]
        conv_s[bu, sb] += P["w1_s"][sb]
        conv_s[bo, sb] += P["w2_s"][sb]
        for b in range(bu + 1, bo):
            conv_s[b, sb] += 1.0
    s3_short = P["s3_l"].copy()
    s3_short[CBANDS_S:, :] = 0.0
    s3_short[:, CBANDS_S:] = 0.0
    return dict(P=P, part_l=part_l, part_s=part_s, s3=s3, s3_short=s3_short,
                conv_l=conv_l, conv_s=conv_s)


def _frames_long(blocks, halo2):
    """(G, 1024) long FFT windows from (G, 576) blocks.

    halo2: (2, 576) the two blocks preceding blocks[0] (zeros at start).
    Window g covers stream[576 g - 768, 576 g + 256) =
    [tail 192 of g-2 | g-1 | head 256 of g].
    """
    allb = jnp.concatenate([halo2, blocks], axis=0)  # (G+2, 576)
    g2 = allb[:-2, 384:]      # (G, 192)
    g1 = allb[1:-1, :]        # (G, 576)
    g0 = allb[2:, :256]       # (G, 256)
    return jnp.concatenate([g2, g1, g0], axis=1)


def _frames_short(blocks, halo2):
    """(G, 3, 256) short FFT windows at offsets 256/384/512 within the
    1344-sample savebuf = stream[576g-768 ...)."""
    allb = jnp.concatenate([halo2, blocks], axis=0)
    # offset within stream: 576g - 768 + 256 + 128*w
    # = 576(g-1) + 64 + 128*w ; windows of 256 samples
    base = jnp.concatenate([allb[:-1], allb[1:]], axis=1)  # (G+1, 1152) [g-1|g]
    per_w = [base[1:, 64 + 128 * w: 64 + 128 * w + 256] for w in range(3)]
    return jnp.stack(per_w, axis=1)


def _spectrum(frames, n, dtype):
    C, S = _dft_mats(n)
    re = frames @ jnp.asarray(C, dtype)
    im = frames @ jnp.asarray(S, dtype)
    energy = re * re + im * im
    # energy floor with zero-phase convention (subs.c:67-80)
    interior = jnp.ones(n // 2 + 1, bool).at[0].set(False).at[n // 2].set(False)
    floored = (energy < 0.0005) & interior
    energy = jnp.where(floored, 0.0005, energy)
    re = jnp.where(floored, jnp.sqrt(energy), re)
    im = jnp.where(floored, 0.0, im)
    return re, im, energy


def _fsm_blocktype(attack, init_state=None):
    """Block-type FSM as an associative scan over state maps.

    States: 0=NORM, 2=SHORT, 3=STOP (START never persists).
    map_attack[s] = SHORT ; map_calm[s] = STOP if s==SHORT else NORM.
    emit = attack ? (state==NORM ? START : SHORT) : state.

    init_state: scalar int32 automaton state before attack[0] (NORM at
    stream start); threading it between fixed-size chunks makes the
    chunked encode's emitted block types identical to a whole-clip
    scan.  Returns (emit, final_state).
    """
    maps = fsm_maps(attack)
    prefix = jax.lax.associative_scan(fsm_compose, maps, axis=0)
    if init_state is None:
        init_state = jnp.zeros((), jnp.int32)
    init_state = jnp.asarray(init_state, jnp.int32)
    # state BEFORE granule g = prefix[g-1] applied to the init state
    pre = jnp.take_along_axis(
        prefix, jnp.broadcast_to(init_state, (prefix.shape[0], 1)), axis=1)[:, 0]
    states = jnp.concatenate([init_state[None], pre[:-1]])
    emit = jnp.where(attack,
                     jnp.where(states == 0, 1, 2),
                     states)
    return emit.astype(jnp.int32), pre[-1]


def fsm_compose(a, b):
    """Compose transition maps over state domain [0..3]: (b.a)[s] = b[a[s]]."""
    return jnp.take_along_axis(b, a, axis=-1)


def fsm_maps(attack):
    """Per-granule transition maps (G, 4) of the block-type automaton.
    Reducing them with fsm_compose yields a chunk's total map, so the
    cross-chunk FSM state becomes an associative scan over tiny
    4-vectors -- the multi-chip path all_gathers one map per chunk and
    every device composes the global prefix locally."""
    m_attack = jnp.array([2, 2, 2, 2], jnp.int32)
    m_calm = jnp.array([0, 0, 3, 0], jnp.int32)
    return jnp.where(attack[:, None], m_attack[None, :], m_calm[None, :])


def psycho_granules(blocks, halo2, sfreq_hz, dtype=jnp.float32,
                    warmup=0, fsm_init=None):
    """Model-2 analysis for a batch of granules of one channel.

    blocks: (G, 576) raw PCM sample values (int16 range, as float).
    halo2: (2, 576) preceding blocks (zeros at stream start).
    warmup: static int -- the first `warmup` granules of `blocks` are
      history-only (their FFT spectra and pre-echo nb feed the real
      granules' unpredictability/threshold chains, which reach 2
      granules back); their own outputs are dropped.  With warmup=2 and
      the 4 preceding blocks supplied (2 as warmup rows of `blocks`, 2
      as halo2), a fixed-size chunk computes exactly what a whole-clip
      batch would.
    fsm_init: scalar int32 block-type automaton state carried from the
      previous chunk (None = NORM, stream start).
    Returns per-granule *computed* quantities (no emission delay --
    the model applies the delay/staleness when assembling):
      pe (G-warmup,), ratio_l (G-warmup,21), ratio_s (G-warmup,12,3),
      attack (G-warmup,) bool, block_type (G-warmup,) emitted (FSM
      output), fsm_state () carry for the next chunk.
    """
    M = _psy_mats(float(sfreq_hz))
    P = M["P"]
    blocks = blocks.astype(dtype)
    halo2 = halo2.astype(dtype)
    return _psycho_granules_body(blocks, halo2, M, P, dtype, warmup,
                                 fsm_init)


# the DFT/partition/spreading matmuls feed threshold and block-type
# decisions, so they run at full f32
@exact_matmuls
def _psycho_granules_body(blocks, halo2, M, P, dtype, warmup=0,
                          fsm_init=None):
    frames_l = _frames_long(blocks, halo2) * jnp.asarray(_hann(1024), dtype)
    re, im, energy = _spectrum(frames_l, 1024, dtype)        # (G, 513)
    frames_s = _frames_short(blocks, halo2) * jnp.asarray(_hann(256), dtype)
    re_s, im_s, energy_s = _spectrum(frames_s, 256, dtype)   # (G, 3, 129)

    G = blocks.shape[0]
    r = jnp.sqrt(energy)

    # --- unpredictability, long lines 0..5 (two-granule history)
    z = jnp.zeros((1,) + re.shape[1:], dtype)
    re1 = jnp.concatenate([z, re[:-1]]); im1 = jnp.concatenate([z, im[:-1]])
    re2 = jnp.concatenate([z, z, re[:-2]]); im2 = jnp.concatenate([z, z, im[:-2]])
    r1 = jnp.concatenate([jnp.zeros((1, 513), dtype), r[:-1]])
    r2 = jnp.concatenate([jnp.zeros((2, 513), dtype), r[:-2]])
    cw = _unpredictability(re, im, r, re1, im1, r1, re2, im2, r2)

    # short-derived lines 6..205 (within-granule, 3 sub-blocks)
    rs = jnp.sqrt(energy_s)
    k = (np.arange(6, 206, 4) + 2) >> 2
    cws = _unpredictability(
        re_s[:, 1, k], im_s[:, 1, k], rs[:, 1, k],
        re_s[:, 0, k], im_s[:, 0, k], rs[:, 0, k],
        re_s[:, 2, k], im_s[:, 2, k], rs[:, 2, k])
    cw_full = jnp.full((G, 513), 0.4, dtype)
    cw_full = cw_full.at[:, :6].set(cw[:, :6])
    cw_full = cw_full.at[:, 6:206].set(jnp.repeat(cws, 4, axis=1))

    # --- partition energies and spreading
    eb = energy @ jnp.asarray(M["part_l"], dtype)            # (G, 63)
    cbw = (cw_full * energy) @ jnp.asarray(M["part_l"], dtype)
    ecb = eb @ jnp.asarray(M["s3"].T, dtype)
    ctb = cbw @ jnp.asarray(M["s3"].T, dtype)

    # --- tonality -> SNR -> thresholds with pre-echo memory
    cbb = jnp.where(ecb != 0.0, jnp.log(jnp.maximum(ctb / jnp.where(ecb == 0, 1, ecb), 0.01)), 0.0)
    tbb = jnp.clip(-0.299 - 0.43 * cbb, 0.0, 1.0)
    snr_l = jnp.maximum(jnp.asarray(P["minval"], dtype), 29.0 * tbb + 6.0 * (1.0 - tbb))
    nb = ecb * jnp.asarray(P["norm_l"], dtype) * jnp.exp(-snr_l * LN)
    zb = jnp.zeros((1, CBANDS), dtype)
    nb1 = jnp.concatenate([zb, nb[:-1]])
    nb2 = jnp.concatenate([zb, zb, nb[:-2]])
    thr = jnp.maximum(jnp.asarray(P["qthr_l"], dtype),
                      jnp.minimum(nb, jnp.minimum(2.0 * nb1, 16.0 * nb2)))

    # --- perceptual entropy (with the reference's clobbered numlines)
    pe = -jnp.sum(jnp.asarray(P["numlines_pe"], dtype) *
                  jnp.minimum(0.0, jnp.log((thr + 1.0) / (eb + 1.0))), axis=1)

    # --- long sfb ratios
    en_l = eb @ jnp.asarray(M["conv_l"], dtype)
    thm_l = thr @ jnp.asarray(M["conv_l"], dtype)
    ratio_l = jnp.where(en_l != 0.0, thm_l / jnp.where(en_l == 0, 1, en_l), 0.0)

    # --- short sfb ratios
    eb_s = energy_s @ jnp.asarray(M["part_s"], dtype)        # (G, 3, 63)
    ecb_s = eb_s @ jnp.asarray(M["s3_short"].T, dtype)
    nb_sv = ecb_s * jnp.asarray(P["norm_l"], dtype) * \
        jnp.exp(jnp.asarray(P["snr_s"], dtype) * LN)
    thr_s = jnp.maximum(jnp.asarray(P["qthr_s"], dtype), nb_sv)
    en_s = eb_s @ jnp.asarray(M["conv_s"], dtype)            # (G, 3, 12)
    thm_s = thr_s @ jnp.asarray(M["conv_s"], dtype)
    ratio_s = jnp.where(en_s != 0.0, thm_s / jnp.where(en_s == 0, 1, en_s), 0.0)
    ratio_s = ratio_s.transpose(0, 2, 1)                     # (G, 12, 3)

    attack = pe >= SWITCH_PE
    if warmup:
        pe, ratio_l, ratio_s, attack = (x[warmup:] for x in
                                        (pe, ratio_l, ratio_s, attack))
    block_type, fsm_state = _fsm_blocktype(attack, fsm_init)
    return dict(pe=pe, ratio_l=ratio_l, ratio_s=ratio_s, attack=attack,
                block_type=block_type, fsm_state=fsm_state)


def _unpredictability(re0, im0, r0, re1, im1, r1, re2, im2, r2):
    """cw = |X - r' u| / (r + |r'|), u = unit(2 phi1 - phi2), without
    transcendentals (l3psy.c:496-512 computed via cos/sin of phases)."""
    rp = 2.0 * r1 - r2
    # unit vector with angle 2*phi1 - phi2:
    #   e^{i 2 phi1} = (X1/r1)^2 ; e^{-i phi2} = conj(X2)/r2
    # zero-magnitude spectra take phase 0 (enphinew convention)
    d1 = jnp.where(r1 == 0, 1.0, r1)
    d2 = jnp.where(r2 == 0, 1.0, r2)
    u1re = jnp.where(r1 == 0, 1.0, (re1 * re1 - im1 * im1) / (d1 * d1))
    u1im = jnp.where(r1 == 0, 0.0, (2.0 * re1 * im1) / (d1 * d1))
    c2re = jnp.where(r2 == 0, 1.0, re2 / d2)
    c2im = jnp.where(r2 == 0, 0.0, -im2 / d2)
    ure = u1re * c2re - u1im * c2im
    uim = u1im * c2re + u1re * c2im
    t1 = re0 - rp * ure
    t2 = im0 - rp * uim
    t3 = r0 + jnp.abs(rp)
    return jnp.where(t3 != 0.0, jnp.sqrt(t1 * t1 + t2 * t2) / jnp.where(t3 == 0, 1, t3), 0.0)
