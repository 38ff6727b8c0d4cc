"""On-device Layer III main_data emission: Huffman codewords +
scalefactors materialized as (value, length) elements and bit-packed
into per-granule payload buffers — entirely on the device.

Why: raw ix is 10.6 MB for a 60 s stereo clip, the entropy-coded
main_data about 1 MB at 128 kbps.  Emitting the payload on device
shrinks the device-to-host transfer to the latter and reduces the host
assembler (native/mp3bits.cpp) to a header/side-info weave.

Semantics replicate l3bitstream.c:516-716 (Huffman emission with ESC
linbits and sign packing) and :195-254 (scalefactor emission); the
byte-exact Python oracle is mp3tpu/numpy_ref/bitstream.py
(encode_scalefacs / encode_spectrum), which tests compare against.

The bit packer is a fixed-depth merge tree over (value, length)
elements: each level concatenates pairs of MSB-aligned word buffers
with a per-lane dynamic bit offset (gather + shift + or) — O(E log E)
word traffic, no scatters, fully fused by XLA.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import mpeg
from ..tables.huffman import HUFF

# pair (code | hlen<<19) fused LUT as int8 nibble planes: the lookup
# is an exact int8 one-hot matmul instead of a per-element gather
# (codes <= 19 bits, hlen <= 19, so 6 nibbles cover code+hlen)
_PAIR_COMBINED = (HUFF.codes.reshape(34, 256).astype(np.int64)
                  | (HUFF.hlen.reshape(34, 256).astype(np.int64) << 19))
_PAIR_NIB = np.stack([((_PAIR_COMBINED >> (4 * k)) & 15).astype(np.int8)
                      for k in range(6)])                 # (6, 34, 256)
_LINBITS = HUFF.linbits.astype(np.int32)
_C1_CODES = HUFF.codes[32:34, 0, :16].astype(np.uint32)   # (2, 16)
_C1_HLEN = HUFF.hlen[32:34, 0, :16].astype(np.int32)      # (2, 16)
# count1 fused (code | hlen<<6): codes <= 6 bits, hlen <= 6
_C1_COMBINED = (_C1_CODES.astype(np.float32)
                + (_C1_HLEN.astype(np.float32) * 64.0))   # (2, 16) f32
_SLEN1 = mpeg.SLEN1_TAB.astype(np.int32)
_SLEN2 = mpeg.SLEN2_TAB.astype(np.int32)

PAYLOAD_WORDS = 128   # 4096 bits >= max part2_3_length (12-bit field)


def _u32(x):
    return x.astype(jnp.uint32)


def scalefac_elements(sf_l, sf_s, compress, is_short, skip_mask=None):
    """Scalefactor (value, length) elements, 36 slots per granule.

    Short blocks (l3bitstream.c:240-254): sfb 0..5 x3 windows at slen1
    then sfb 6..11 x3 at slen2 — exactly 36 slots in (sfb, window)
    order.  Long blocks (:221-238): sfb 0..10 at slen1, 11..20 at
    slen2 in the first 21 slots, rest 0.  skip_mask (G, 21): long sfbs
    NOT transmitted (scfsi bands, l3bitstream.c:228-236).
    """
    G = sf_l.shape[0]
    slen1 = jnp.asarray(_SLEN1)[compress]          # (G,)
    slen2 = jnp.asarray(_SLEN2)[compress]
    j = jnp.arange(36)
    # short layout
    sfb_s = j // 3
    val_s = sf_s.reshape(G, 36)
    len_s = jnp.where(sfb_s[None, :] < 6, slen1[:, None], slen2[:, None])
    # long layout
    val_l = jnp.pad(sf_l, ((0, 0), (0, 15)))
    len_l = jnp.where(j[None, :] < 11, slen1[:, None],
                      jnp.where(j[None, :] < 21, slen2[:, None], 0))
    if skip_mask is not None:
        skip36 = jnp.pad(skip_mask, ((0, 0), (0, 15)))
        len_l = jnp.where(skip36, 0, len_l)
    values = jnp.where(is_short[:, None], val_s, val_l)
    lengths = jnp.where(is_short[:, None], len_s, len_l)
    return _u32(values), lengths.astype(jnp.int32)


_P_LONG_T0 = np.repeat(np.arange(4), mpeg.NR_OF_SFB_BLOCK[0][0])  # (21,)
_P_LONG_T2 = np.repeat(np.arange(4), mpeg.NR_OF_SFB_BLOCK[2][0])  # (21,)
_P_SHORT_T0 = np.repeat(np.arange(4), mpeg.NR_OF_SFB_BLOCK[0][1] // 3)
_P_SHORT_T2 = np.repeat(np.arange(4), mpeg.NR_OF_SFB_BLOCK[2][1] // 3)


def scalefac_elements_lsf(sf_l, sf_s, compress, is_short):
    """MPEG-2 LSF scalefactor elements, 36 slots per granule.

    The four slen values and the sfb partition are derived from the
    9-bit scalefac_compress exactly as a decoder does (IS 13818-3
    2.4.3.2); table_number 2 (preflag) is implied by compress >= 500.
    Long: sfb 0..20 in partition order; short: (sfb, window) slots.
    """
    G = sf_l.shape[0]
    sc = compress.astype(jnp.int32)
    pre = sc >= 500
    slen_t0 = jnp.stack([(sc >> 4) // 5, (sc >> 4) % 5,
                         (sc & 15) >> 2, sc & 3], axis=1)
    s2 = jnp.maximum(sc - 500, 0)
    slen_t2 = jnp.stack([s2 // 3, s2 % 3, s2 * 0, s2 * 0], axis=1)
    slen = jnp.where(pre[:, None], slen_t2, slen_t0)      # (G, 4)

    pl = jnp.where(pre[:, None], jnp.asarray(_P_LONG_T2)[None],
                   jnp.asarray(_P_LONG_T0)[None])         # (G, 21)
    len_l = jnp.take_along_axis(slen, pl, axis=1)         # (G, 21)
    len_l = jnp.pad(len_l, ((0, 0), (0, 15)))
    ps = jnp.where(pre[:, None], jnp.asarray(_P_SHORT_T2)[None],
                   jnp.asarray(_P_SHORT_T0)[None])        # (G, 12)
    j = jnp.arange(36)
    len_s = jnp.take_along_axis(slen, jnp.take_along_axis(
        ps, jnp.broadcast_to(j[None, :] // 3, (G, 36)), axis=1), axis=1)

    val_l = jnp.pad(sf_l, ((0, 0), (0, 15)))
    val_s = sf_s.reshape(G, 36)
    values = jnp.where(is_short[:, None], val_s, val_l)
    lengths = jnp.where(is_short[:, None], len_s, len_l)
    return _u32(values), lengths.astype(jnp.int32)


def pair_elements(ix_signed, a1, a2, big_values, table_select, is_short,
                  ST):
    """Huffman elements for the 288 big-value pairs: per pair a code
    element (code + packed sign bits for tables <= 15) and an ext
    element (ESC linbits + signs, tables > 15), interleaved in stream
    order.  Returns (values (G, 576), lengths (G, 576))."""
    G = ix_signed.shape[0]
    perm = jnp.asarray(ST["perm_short"])
    ixp = jnp.where(is_short[:, None], ix_signed[:, perm], ix_signed)
    pairs = ixp.reshape(G, 288, 2)
    xs, ys = pairs[:, :, 0], pairs[:, :, 1]
    sgx = (xs < 0).astype(jnp.uint32)
    sgy = (ys < 0).astype(jnp.uint32)
    x = jnp.abs(xs)
    y = jnp.abs(ys)

    pos2 = 2 * jnp.arange(288)[None, :]
    ts = table_select
    region_long = jnp.where(pos2 < a1[:, None], 0,
                            jnp.where(pos2 < a2[:, None], 1, 2))
    region_short = jnp.where(
        jnp.arange(288)[None, :] < ST["r0_pairs_short"], 0, 1)
    region = jnp.where(is_short[:, None], region_short, region_long)
    reg_oh = jax.nn.one_hot(region, 3, dtype=jnp.int32)   # (G, 288, 3)
    t = jnp.sum(ts[:, None, :] * reg_oh, axis=2)          # (G, 288)
    valid = jnp.where(is_short[:, None], True, pos2 < 2 * big_values[:, None])
    valid = valid & (t > 0)

    xc = jnp.minimum(x, 15)
    yc = jnp.minimum(y, 15)
    # (code | hlen<<19) lookup as int8 one-hot matmuls: select each
    # region's LUT row (nibble planes), then contract the per-pair
    # class one-hot against the rows and pick the pair's region
    pidx = xc * 16 + yc
    ts_oh = jax.nn.one_hot(jnp.clip(ts, 0, 33), 34, dtype=jnp.int8)
    rows = jnp.einsum("grt,ktc->kgrc", ts_oh, jnp.asarray(_PAIR_NIB),
                      preferred_element_type=jnp.int32) \
        .astype(jnp.int8)                                 # (6, G, 3, 256)
    ohp = jax.nn.one_hot(pidx, 256, dtype=jnp.int8)       # (G, 288, 256)
    per_reg = jnp.einsum("gpc,kgrc->kgpr", ohp, rows,
                         preferred_element_type=jnp.int32)
    comb_nib = jnp.sum(per_reg * reg_oh[None], axis=-1)   # (6, G, 288)
    combined = comb_nib[0]
    for k in range(1, 6):
        combined = combined | (comb_nib[k] << (4 * k))
    code = _u32(combined & 0x7FFFF)
    cbits = combined >> 19
    linbits_r = jnp.sum(jnp.asarray(_LINBITS)[None, None, :]
                        * ts_oh.astype(jnp.int32), axis=2)  # (G, 3)
    linbits = jnp.sum(linbits_r[:, None, :] * reg_oh, axis=2)
    esc = t > 15

    # tables <= 15: append sign bits into the code (l3bitstream.c:860)
    nx = (x != 0).astype(jnp.int32)
    ny = (y != 0).astype(jnp.int32)
    csmall = jnp.where(nx == 1, (code << 1) | sgx, code)
    csmall = jnp.where(ny == 1, (csmall << 1) | sgy, csmall)
    lsmall = cbits + nx + ny

    # ESC ext field (l3bitstream.c:826-850): linbits(x-15), sign x,
    # linbits(y-15), sign y — each present per its own condition
    linx = _u32(jnp.maximum(x - 15, 0))
    liny = _u32(jnp.maximum(y - 15, 0))
    bx = x > 14
    by = y > 14
    ext = jnp.where(bx, linx, jnp.uint32(0))
    xb = jnp.where(bx, linbits, 0)
    ext = jnp.where(nx == 1, (ext << 1) | sgx, ext)
    xb = xb + nx
    ext = jnp.where(by, (ext << linbits) | liny, ext)
    xb = xb + jnp.where(by, linbits, 0)
    ext = jnp.where(ny == 1, (ext << 1) | sgy, ext)
    xb = xb + ny

    code_val = jnp.where(esc, code, csmall)
    code_len = jnp.where(esc, cbits, lsmall)
    ext_len = jnp.where(esc, xb, 0)
    code_len = jnp.where(valid, code_len, 0)
    ext_len = jnp.where(valid, ext_len, 0)

    values = jnp.stack([code_val, ext], axis=2).reshape(G, 576)
    lengths = jnp.stack([code_len, ext_len], axis=2).reshape(G, 576)
    return _u32(values), lengths.astype(jnp.int32)


def count1_elements(ix_signed, big_values, count1, c1ts):
    """count1-region quads (l3bitstream.c:728-767): code + a sign bit
    after each nonzero component, packed into one element per quad
    (<= 10 bits).

    The quad region starts at 2*big_values -- 2-aligned, not 4-aligned;
    shift odd-pair-count granules left by 2 (same alignment trick as
    jaxloop._count1_bits) so quads sit at STATIC positions and the
    per-granule dynamic gather disappears; the (code | hlen<<6) lookup
    is an exact one-hot f32 matmul (values < 2^24)."""
    G = ix_signed.shape[0]
    start = 2 * big_values
    mis = (start % 4) != 0
    ixs = jnp.where(mis[:, None], jnp.roll(ix_signed, -2, axis=1),
                    ix_signed)
    start = jnp.where(mis, start - 2, start)
    q = ixs.reshape(G, 144, 4)
    a = jnp.minimum(jnp.abs(q), 1)       # region values are 0/±1
    sg = (q < 0).astype(jnp.uint32)
    # conformant quad index (v<<3)|(w<<2)|(x<<1)|y, v = first sample --
    # the reference reverses this and its quads decode sample-reversed
    # in conforming decoders (see jaxloop._count1_bits); sign bits
    # already follow in sample order (= v,w,x,y order) either way
    p = 8 * a[:, :, 0] + 4 * a[:, :, 1] + 2 * a[:, :, 2] + a[:, :, 3]
    row = jnp.where(c1ts[:, None] == 0,
                    jnp.asarray(_C1_COMBINED[0])[None, :],
                    jnp.asarray(_C1_COMBINED[1])[None, :])   # (G, 16)
    ohq = jax.nn.one_hot(p, 16, dtype=jnp.float32)
    comb = jnp.einsum("gqc,gc->gq", ohq, row,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32).astype(jnp.int32)
    code = _u32(comb & 63)
    hl = comb >> 6
    for k in range(4):
        nz = a[:, :, k] != 0
        code = jnp.where(nz, (code << 1) | sg[:, :, k], code)
        hl = hl + nz.astype(jnp.int32)
    q4 = 4 * jnp.arange(144)[None, :]
    valid = (q4 >= start[:, None]) & (q4 < (start + 4 * count1)[:, None])
    hl = jnp.where(valid, hl, 0)
    return _u32(code), hl.astype(jnp.int32)


def granule_elements(state, ix_signed, is_short, ST, skip_mask=None):
    """Full main_data element stream for a batch of granules:
    36 scalefactor slots + 576 pair slots + 144 quad slots = 756.
    state: the outer_loop output dict."""
    if ST.get("lsf"):
        sv, sl = scalefac_elements_lsf(state["sf_l"], state["sf_s"],
                                       state["compress"], is_short)
    else:
        sv, sl = scalefac_elements(state["sf_l"], state["sf_s"],
                                   state["compress"], is_short,
                                   skip_mask=skip_mask)
    pv, pl = pair_elements(ix_signed, state["a1"], state["a2"],
                           state["big_values"], state["table_select"],
                           is_short, ST)
    qv, ql = count1_elements(ix_signed, state["big_values"],
                             state["count1"],
                             state["count1table_select"])
    values = jnp.concatenate([sv, pv, qv], axis=1)
    lengths = jnp.concatenate([sl, pl, ql], axis=1)
    return values, lengths


def pack_elements(values, lengths, w_cap=PAYLOAD_WORDS):
    """Bit-pack (G, E) MSB-first elements -> ((G, w_cap) u32 words,
    (G,) total bits).

    Formulation: element bit offsets come from a cumsum; each element
    contributes to at most two 32-bit output words (all lengths <= 32)
    and contributions to the same word occupy DISJOINT bits, so OR ==
    SUM and the whole scatter is an exact one-hot matmul:
    nibble-decompose the aligned contributions (int8-safe), contract
    (G, E) x (G, E, W) over the element axis, and recombine.  No
    scans, no gathers, no scatters (an earlier segmented-OR-scan +
    searchsorted formulation was dominated by its gather loops)."""
    G, E = values.shape
    lengths = lengths.astype(jnp.int32)
    vmask = jnp.where(lengths >= 32, jnp.uint32(0xFFFFFFFF),
                      (jnp.uint32(1) << _u32(lengths)) - jnp.uint32(1))
    v = _u32(values) & vmask
    v_msb = jnp.where(lengths > 0, v << _u32(32 - lengths), jnp.uint32(0))

    end = jnp.cumsum(lengths, axis=1)
    off = end - lengths                                   # exclusive
    nbits = end[:, -1]
    w0 = off >> 5                                         # start word
    r = _u32(off & 31)
    c0 = v_msb >> r                                       # into word w0
    c1 = jnp.where(r > 0, v_msb << (jnp.uint32(32) - r),
                   jnp.uint32(0))                         # into word w0+1

    oh = jax.nn.one_hot(w0, w_cap, dtype=jnp.int8)        # (G, E, W)
    nib = jnp.stack([((c0 >> (4 * k)) & 15).astype(jnp.int8)
                     for k in range(8)]
                    + [((c1 >> (4 * k)) & 15).astype(jnp.int8)
                       for k in range(8)])                # (16, G, E)
    m = jnp.einsum("kge,gew->kgw", nib, oh,
                   preferred_element_type=jnp.int32)      # (16, G, W)
    w_at = _u32(m[:8])
    w_next = _u32(m[8:])
    words0 = jnp.zeros((G, w_cap), jnp.uint32)
    words1 = jnp.zeros((G, w_cap), jnp.uint32)
    for k in range(8):
        words0 = words0 | (w_at[k] << jnp.uint32(4 * k))
        words1 = words1 | (w_next[k] << jnp.uint32(4 * k))
    # c1 lands one word after its element's start word
    words = words0 | jnp.pad(words1, ((0, 0), (1, 0)))[:, :-1]
    return words, nbits


def granule_payload(state, ix_signed, is_short, ST,
                    w_cap=PAYLOAD_WORDS, skip_mask=None):
    """Emit + pack a batch of granules' main_data.

    Returns (payload (G, w_cap) u32 MSB-first, nbits (G,)).  nbits
    equals part2_3_length by construction (stuffing is drained to the
    ancillary region by the host weave, never inside the granule)."""
    values, lengths = granule_elements(state, ix_signed, is_short, ST,
                                       skip_mask=skip_mask)
    return pack_elements(values, lengths, w_cap)


@partial(jax.jit, static_argnames=("w_cap",))
def pack_elements_jit(values, lengths, w_cap=PAYLOAD_WORDS):
    return pack_elements(values, lengths, w_cap)


def compact_payload(payload, nbits, total_cap):
    """Row-compact a (N, W) payload into ONE flat (total_cap,) u32
    buffer: lane g's ceil(nbits[g]/32) used words land at word offset
    cumsum-exclusive(wlen)[g], lane order preserved.

    Why: the dense payload is mostly zeros (rows sized for the worst
    granule, ~4x the mean at 128 kbps), so compaction cuts the
    device-to-host copy ~4x.  The host re-derives the identical
    offsets from the side table's part2_3_length, so only this buffer
    is copied.

    Formulation: lane-of-word via a scatter-add of one mark per
    lane at its start offset + cumsum (duplicate marks from empty lanes
    resolve to the LAST lane at that offset, which is exactly the
    non-empty one), then a single 1-D gather.  total_cap must bound
    sum(wlen); the reservoir bounds sum(p23) by the CBR total plus
    resv_max, so callers size it statically from the bitrate.
    """
    N, W = payload.shape
    wlen = ((nbits + 31) >> 5).astype(jnp.int32)
    ends = jnp.cumsum(wlen)
    off = ends - wlen
    marks = jnp.zeros(total_cap + 1, jnp.int32) \
        .at[jnp.minimum(off, total_cap)].add(1)
    lane = jnp.cumsum(marks[:total_cap]) - 1
    lane = jnp.clip(lane, 0, N - 1)
    j = jnp.arange(total_cap, dtype=jnp.int32) - off[lane]
    ok = (j >= 0) & (j < W)
    idx = lane * W + jnp.where(ok, j, 0)
    return jnp.where(ok, payload.reshape(-1)[idx], jnp.uint32(0))


def payload_cap_words(n_frames, bits_per_frame, sideinfo_len, resv_max,
                      n_lanes):
    """Static flat-buffer size: the reservoir guarantees
    sum(part2_3_length) <= frames*(frame bits - side info) + resv_max
    (reservoir.c:101-134 grant policy); per-lane word alignment adds at
    most one word per lane."""
    total_bits = n_frames * (bits_per_frame - sideinfo_len) + resv_max
    return int(total_bits // 32 + n_lanes + 16)
