"""Layer III granule-batch encoder: the jitted device compute graph.

One call processes a batch of granules for one channel through
psy -> filterbank -> MDCT -> rate loop, entirely on device.  The
sequential reference structures become:

  - cross-frame DSP/psy state: halo inputs (512 samples + previous
    granule's subbands + 2 psy blocks), so shards compose with a
    ppermute halo exchange (mp3tpu/parallel);
  - the bit reservoir: granules are first encoded *unconstrained*
    (budget 4095) to reveal their bit demand; the exact reservoir
    policy then runs as a cheap scalar scan on the host, and only
    budget-limited granules are re-encoded at their precise budget
    (mp3tpu/encoder.py).  One fix-up round yields a valid CBR stream
    because repair only ever returns bits to the reservoir.

Production-mode quality deviations from the reference (all strictly
better; the byte-exact replica lives in mp3tpu/numpy_ref):
  - true quantization range handling instead of the saturating
    pow_nint table (see tests/golden/ref_snr.json for the damage);
  - psychoacoustic outputs are used for the granule they were computed
    on (the reference pairs each granule with the previous analysis
    window, l3psy.c:452-456);
  - no scfsi (a small rate optimization, rarely active in the
    reference due to loop.c:676's integer truncations).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import exact_matmuls, jaxbits, jaxdsp, jaxloop, jaxpsy
from ..tables import mpeg

#: sfb -> scfsi band map (loop.c scfsi_band_long 0,6,11,16,21)
_BAND_OF_SFB = np.repeat(np.arange(4), np.diff(mpeg.SCFSI_BAND_LONG))


@exact_matmuls
def _scfsi_flags(xr, ratio_l, ratio_s, block_type, ST):
    """scfsi decision for one channel's granule batch (loop.c:615-720
    semantics with the intended per-channel indexing, not the
    reference's transposed-index quirk at loop.c:676).

    xr (C, 576): granule pairs are (2f, 2f+1).  Returns (C//2, 4)
    int32 flags: both granules non-short, non-silent, spectral-energy
    and allowed-distortion profiles within the reference's similarity
    thresholds per scfsi band.
    """
    C = xr.shape[0]
    xr_abs = jnp.abs(xr)
    xmin_l, _ = jaxloop.calc_xmin(xr_abs, ratio_l, ratio_s, ST)
    oh_l = jnp.asarray(ST["oh_l"], xr.dtype)
    en_sfb = (xr_abs * xr_abs) @ oh_l                     # (C, 21)
    ln2 = float(np.log(2.0))
    en = jnp.where(en_sfb > 0,
                   jnp.trunc(jnp.log(jnp.maximum(en_sfb, 1e-37)) / ln2),
                   0.0)
    xm = jnp.where(xmin_l > 0,
                   jnp.trunc(jnp.log(jnp.maximum(xmin_l, 1e-37)) / ln2),
                   0.0)
    # reference scale: xr in int16 units; int(max|xr|) != 0
    nonsilent = jnp.max(xr_abs, axis=1) * 32768.0 >= 1.0
    long_ok = block_type != 2

    en0, en1 = en[0::2], en[1::2]
    xm0, xm1 = xm[0::2], xm[1::2]
    cond = (nonsilent[0::2] & nonsilent[1::2]
            & long_ok[0::2] & long_ok[1::2]
            & (jnp.sum(jnp.abs(en0 - en1), axis=1) < 100.0))
    band_oh = jnp.asarray(
        (np.arange(4)[None, :] == _BAND_OF_SFB[:, None]).astype(np.float32),
        xr.dtype)                                          # (21, 4)
    den = jnp.abs(en0 - en1) @ band_oh                     # (C/2, 4)
    dxm = jnp.abs(xm0 - xm1) @ band_oh
    flags = cond[:, None] & (den < 10.0) & (dxm < 10.0)
    return flags.astype(jnp.int32)


@partial(jax.jit, static_argnames=("version", "sampling_frequency", "sfreq_hz"))
def analyze_granules(blocks, halo_samples, version, sampling_frequency,
                     sfreq_hz):
    """Psy + DSP for one channel batch.

    blocks: (G, 576) int16-valued floats.
    halo_samples: (2, 576) preceding blocks (zeros at stream start).
    Returns dict with xr (G, 576), psy outputs, block_type.
    """
    psy = jaxpsy.psycho_granules(blocks, halo_samples, sfreq_hz)
    scaled = blocks / 32768.0
    halo_scaled = halo_samples / 32768.0
    sb = jaxdsp.subband_granules(scaled, halo_scaled[1, 64:])
    # previous granule's subbands for MDCT overlap come from the halo:
    sb_prev = jaxdsp.subband_granules(
        halo_scaled[1][None], halo_scaled[0, 64:])[0]
    xr = jaxdsp.mdct_granules(sb, sb_prev, psy["block_type"])
    return dict(xr=xr, pe=psy["pe"], ratio_l=psy["ratio_l"],
                ratio_s=psy["ratio_s"], block_type=psy["block_type"])


@partial(jax.jit, static_argnames=("version", "sampling_frequency"))
def encode_granules(xr, ratio_l, ratio_s, block_type, budget, version,
                    sampling_frequency):
    """Rate loop for a granule batch at given budgets (bits)."""
    ST = jaxloop._static(version, sampling_frequency)
    is_short_block = block_type != mpeg.NORM_TYPE
    out = jaxloop.outer_loop(xr, budget, ratio_l, ratio_s,
                             is_short_block, block_type, ST)
    out["ix"] = jnp.where((xr < 0) & (out["ix"] > 0), -out["ix"], out["ix"])
    return out


@partial(jax.jit, static_argnames=("version", "sampling_frequency",
                                   "sfreq_hz"))
def analyze_demand_fused(blocks_h4, fsm_init, version, sampling_frequency,
                         sfreq_hz):
    """Analysis + unconstrained demand encode for one super-chunk in
    ONE dispatch.

    The fast path runs the whole pipeline as a handful of large
    dispatches with few host syncs (mp3tpu/encoder.py); this program
    is phase 1 -- psy + filterbank + MDCT + the rate loop at the
    unconstrained budget 4095, whose realized part2_3_length ("demand")
    makes the host reservoir scan's usage prediction exact for every
    granule the reservoir does not constrain.

    blocks_h4: (nch, 4+S, 576) int16-valued floats; rows 0:4 are the 4
      blocks preceding the super-chunk (zeros at stream start) -- rows
      0:2 psy halo, rows 2:4 in-batch warmup granules (psy state
      reaches 2 granules back, see jaxpsy.psycho_granules).
    fsm_init: (nch,) int32 block-type automaton state.

    Returns dict of device arrays: xr (nch*S, 576) and its rate-loop
    inputs (kept on device for encode_final), the (pe, p23) scalars the
    reservoir scan needs, scfsi flags + demand granule-0 scalefactors
    for the paired final encode (MPEG-1), and the fsm_state carry.
    """
    nch = blocks_h4.shape[0]
    S = blocks_h4.shape[1] - 4
    blocks = blocks_h4.astype(jnp.float32)
    ST = jaxloop._static(version, sampling_frequency)
    anas = []
    for ch in range(nch):
        anas.append(_analyze_chunk_body(blocks[ch, 2:], blocks[ch, :2],
                                        fsm_init[ch], sfreq_hz))
    fsm_state = jnp.stack([a.pop("fsm_state") for a in anas])
    ana = {k: jnp.concatenate([a[k] for a in anas]) for k in anas[0]}
    # ---- NaN/Inf guard (SURVEY.md section 5.2: the reference has no
    # sanitizers at all).  A granule whose analysis went non-finite
    # (pathological float input or an upstream numerical fault) is
    # DEGRADED TO SILENCE on device instead of poisoning the rate loop
    # -- the stream stays valid; n_nonfinite reports the count.
    finite = (jnp.all(jnp.isfinite(ana["xr"]), axis=1)
              & jnp.isfinite(ana["pe"])
              & jnp.all(jnp.isfinite(ana["ratio_l"]), axis=1)
              & jnp.all(jnp.isfinite(ana["ratio_s"]), axis=(1, 2)))
    ana["xr"] = jnp.where(finite[:, None], ana["xr"], 0.0)
    ana["pe"] = jnp.where(finite, ana["pe"], 0.0)
    ana["ratio_l"] = jnp.where(finite[:, None], ana["ratio_l"], 0.0)
    ana["ratio_s"] = jnp.where(finite[:, None, None], ana["ratio_s"], 0.0)
    budget = jnp.full(nch * S, 4095.0, jnp.float32)
    out = jaxloop.outer_loop(ana["xr"], budget, ana["ratio_l"],
                             ana["ratio_s"],
                             ana["block_type"] != mpeg.NORM_TYPE,
                             ana["block_type"], ST)
    res = dict(xr=ana["xr"], ratio_l=ana["ratio_l"],
               ratio_s=ana["ratio_s"], block_type=ana["block_type"],
               pe=ana["pe"], p23=out["part2_3_length"].astype(jnp.int32),
               # iteration-0 stepsize: the sound warm lower bound for
               # the final encode (the post-amp qss can exceed what the
               # final's fixed scalefactors need)
               qss=out["qss0"].astype(jnp.float32),
               fsm_state=fsm_state,
               n_nonfinite=jnp.sum(~finite).astype(jnp.int32))
    if not ST["lsf"]:
        res["scfsi"] = jnp.stack(
            [_scfsi_flags(a["xr"], a["ratio_l"], a["ratio_s"],
                          a["block_type"], ST) for a in anas])
        res["sf_fix"] = out["sf_l"].reshape(nch, S, 21)[:, 0::2] \
            .astype(jnp.int8)
    return res


def _analyze_chunk_body(blocks_ext, halo2, fsm_init, sfreq_hz):
    """One channel's chunk analysis: blocks_ext (C+2, 576) = 2 warmup
    blocks + C real blocks; halo2 (2, 576) precedes the warmups."""
    psy = jaxpsy.psycho_granules(blocks_ext, halo2, sfreq_hz,
                                 warmup=2, fsm_init=fsm_init)
    scaled = blocks_ext / 32768.0
    sb = jaxdsp.subband_granules(scaled[2:], scaled[1, 64:])
    sb_prev = jaxdsp.subband_granules(scaled[1][None], scaled[0, 64:])[0]
    xr = jaxdsp.mdct_granules(sb, sb_prev, psy["block_type"])
    return dict(xr=xr, pe=psy["pe"], ratio_l=psy["ratio_l"],
                ratio_s=psy["ratio_s"], block_type=psy["block_type"],
                fsm_state=psy["fsm_state"])


@partial(jax.jit, static_argnames=("version", "sampling_frequency",
                                   "payload_words", "nch", "flat_cap"))
def encode_final(xr, ratio_l, ratio_s, block_type, budget, version,
                 sampling_frequency, payload_words=jaxbits.PAYLOAD_WORDS,
                 scfsi=None, sf_fix=None, nch=1, qss_lo=None,
                 flat_cap=None):
    """One dense full-batch encode at the final budgets.  The entire
    main_data (scalefactors + Huffman codewords) is emitted and
    bit-packed ON DEVICE (ops/jaxbits); only the entropy-coded payload
    plus the side-info scalars are copied to the host -- the host weave
    (native/mp3bits.cpp) never sees raw spectra.

    scfsi (nch, C//2, 4) int32 + sf_fix (nch, C//2, 21) (MPEG-1 only):
    granule pairs whose marked scalefactor bands are transmitted once
    -- granule 1 reuses granule 0's values (loop.c:615-730).  BOTH
    granules of a pair have those bands' scalefactors fixed to the
    pair's demand-encode values (sf_fix), so the whole batch still
    encodes in ONE parallel outer_loop; granule-1 lanes additionally
    skip emitting the fixed bands and reclaim the bits.
    """
    ST = jaxloop._static(version, sampling_frequency)
    is_short_block = block_type != mpeg.NORM_TYPE
    is_short = is_short_block & (block_type == 2)

    mask = vals = skipm = None
    if scfsi is not None and sf_fix is not None and not ST["lsf"]:
        N = xr.shape[0]
        C = N // nch
        band = scfsi.reshape(nch, C // 2, 4).astype(bool)[:, :, _BAND_OF_SFB]
        mask = jnp.repeat(band, 2, axis=1).reshape(N, 21)
        vals = jnp.repeat(sf_fix.reshape(nch, C // 2, 21), 2,
                          axis=1).reshape(N, 21)
        odd = (jnp.arange(C) % 2 == 1)
        skipm = mask & jnp.tile(odd, (nch,))[:, None]

    out = jaxloop.outer_loop(xr, budget, ratio_l, ratio_s,
                             is_short_block, block_type, ST,
                             sf_fix_mask=mask, sf_fix_val=vals,
                             sf_skip_mask=skipm, qss_lo=qss_lo)
    ix_signed = jnp.where((xr < 0) & (out["ix"] > 0), -out["ix"],
                          out["ix"])
    payload, nbits = jaxbits.granule_payload(out, ix_signed, is_short,
                                             ST, payload_words,
                                             skip_mask=skipm)
    if flat_cap is not None:
        # compact the mostly-zero rows into one flat buffer (~4x less
        # to copy to the host); the host re-derives offsets from the
        # side table's part2_3_length
        payload = jaxbits.compact_payload(payload, nbits, flat_cap)
    return dict(side=pack_state(out, block_type), payload=payload)


@partial(jax.jit, static_argnames=(
    "version", "sampling_frequency", "sfreq_hz", "payload_words", "nch",
    "flat_cap", "mean_bits", "resv_max", "mode_gr", "delta"))
def encode_segment_fused(blocks_h4, fsm_init, size_in, version,
                         sampling_frequency, sfreq_hz, payload_words,
                         nch, flat_cap, n_real, mean_bits, resv_max,
                         mode_gr, delta):
    """ONE device program per segment: analyze+demand -> causal
    reservoir scan (carried level in, level out) -> final encode +
    compacted payload.  Fusing the per-segment chain (3 programs -> 1)
    removes two dispatches per segment and lets XLA schedule the whole
    chain without host round trips.  Returns everything the pipeline
    and the (rare) guard-retry path need.

    n_real is TRACED (not static): the padded frames past it are
    masked out of the reservoir scan and their budget rows forced to
    the unconstrained 4095, so ONE compiled program serves every clip
    length inside a shape bucket (a static n_real re-compiled this --
    the heaviest program in the repo -- for every new remainder
    length).  target/demand come back at the padded width; hosts slice
    [:, :n_real]."""
    from ..ops import jaxresv

    ana = analyze_demand_fused(blocks_h4, fsm_init, version,
                               sampling_frequency, sfreq_hz)
    n_pad = blocks_h4.shape[1] - 4
    pe = ana["pe"].reshape(nch, -1)
    demand = ana["p23"].reshape(nch, -1).astype(jnp.int32)
    valid_f = jnp.arange(n_pad // mode_gr) < (n_real // mode_gr)
    bud, size_out = jaxresv.scan_budgets(
        jaxresv.granule_major(pe, nch, mode_gr),
        jaxresv.granule_major(demand, nch, mode_gr),
        size_in, mean_bits, resv_max, mode_gr, nch, delta,
        valid=valid_f)
    target = jnp.minimum(
        demand, jaxresv.from_granule_major(bud, nch, mode_gr))
    valid_g = jnp.arange(n_pad)[None, :] < n_real
    row = jnp.where(valid_g & (target < demand),
                    target.astype(jnp.float32), 4095.0).reshape(-1)
    h = encode_final(ana["xr"], ana["ratio_l"], ana["ratio_s"],
                     ana["block_type"], row, version,
                     sampling_frequency, payload_words=payload_words,
                     scfsi=ana.get("scfsi"), sf_fix=ana.get("sf_fix"),
                     nch=nch, qss_lo=ana["qss"], flat_cap=flat_cap)
    out = dict(side=h["side"], payload=h["payload"],
               fsm_state=ana["fsm_state"], size=size_out,
               target=target, demand=demand,
               n_nonfinite=ana["n_nonfinite"],
               xr=ana["xr"], ratio_l=ana["ratio_l"],
               ratio_s=ana["ratio_s"], block_type=ana["block_type"],
               qss=ana["qss"])
    if "scfsi" in ana:
        out["scfsi"] = ana["scfsi"]
        out["sf_fix"] = ana["sf_fix"]
    return out


@jax.jit
def pack_state(state, block_type):
    """The (N, 19) side-info table in EXACTLY the layout the native
    assembler consumes (native/mp3bits.cpp GranuleSide) -- built on
    device so ONE buffer (plus the payload) is copied to the host per
    dispatch, and as int16 (every field < 2^15: p23 <= 4095, addresses
    <= 576, compress <= 512), half the bytes of int32 rows."""
    bt = block_type.astype(jnp.int32)
    wsf = (bt != mpeg.NORM_TYPE).astype(jnp.int32)
    z = jnp.zeros_like(wsf)
    ts = state["table_select"].astype(jnp.int32)
    cols = [
        state["part2_3_length"].astype(jnp.int32),     # 0
        state["big_values"].astype(jnp.int32),         # 1
        state["global_gain"].astype(jnp.int32),        # 2
        state["compress"].astype(jnp.int32),           # 3
        wsf,                                           # 4
        jnp.where(wsf == 1, bt, 0),                    # 5
        z,                                             # 6 mixed
        ts[:, 0], ts[:, 1], ts[:, 2],                  # 7-9
        state["r0"].astype(jnp.int32),                 # 10
        state["r1"].astype(jnp.int32),                 # 11
        state["preflag"].astype(jnp.int32),            # 12
        z,                                             # 13 subblock/pad
        state["count1table_select"].astype(jnp.int32),  # 14
        state["part2"].astype(jnp.int32),              # 15
        state["a1"].astype(jnp.int32),                 # 16
        state["a2"].astype(jnp.int32),                 # 17
        state["count1"].astype(jnp.int32),             # 18
    ]
    return jnp.stack(cols, axis=1).astype(jnp.int16)


