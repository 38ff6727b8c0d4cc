"""Layer III rate/distortion loop: the reference's nested
variable-trip searches (loop.c:415-606) reformulated as fixed-shape,
vmappable tensor programs.

Key redesigns (cf. SURVEY.md section 7):
  - quantize is a closed-form elementwise op: ix = round(|xr*2^(-s/4)|^0.75
    - 0.0946).  The reference's pow_nint table saturates at 2047 and
    silently clips loud peaks (pow_nint.h:15-49); here the range check
    uses the true value against the Huffman limit 8206, as the IS
    intends -- a large quality improvement over the reference.
  - run-length partition (calc_runlen) via suffix cumulative products;
  - bit counting for ALL 32 pair tables at once: pair values ->
    one-hot histogram per region (int8 matmul) x fused per-pair cost
    LUT -> (regions, 32) bit totals; table choice is then the
    reference's candidate logic as a branchless select;
  - the stepsize search is a fixed-depth bisection on the predicate
    "fits in budget and within table range", with a short fix-up walk;
  - the outer distortion loop is a bounded lax.while_loop with masked
    per-lane convergence.

All functions operate on a batch of granules (leading axis G).
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import mpeg
from ..tables.dsp import POW_4_3
from ..tables.huffman import (ESC_TABLE_A, ESC_TABLE_B, FIRST_TABLE_FOR_MAX,
                              HUFF)
from . import exact_matmuls

IXMAX = 8191 + 14  # table range limit (loop.c:588)
QMIN, QMAX = -210.0, 45.0  # global_gain in [0, 255]


@lru_cache(maxsize=None)
def _static(version, sampling_frequency):
    """Per-samplerate static tensors."""
    sfb_l = mpeg.sfb_long(version, sampling_frequency)
    sfb_s = mpeg.sfb_short(version, sampling_frequency)
    # long sfb one-hot (576 -> 21) and bandwidths
    oh_l = np.zeros((576, 21))
    for sfb in range(21):
        oh_l[sfb_l[sfb]:sfb_l[sfb + 1], sfb] = 1.0
    bw_l = (sfb_l[1:22] - sfb_l[:21]).astype(np.float64)
    # short sfb one-hot on (192, 3) lines -> (12,)
    oh_s = np.zeros((192, 12))
    for sfb in range(12):
        oh_s[sfb_s[sfb]:sfb_s[sfb + 1], sfb] = 1.0
    bw_s = (sfb_s[1:13] - sfb_s[:12]).astype(np.float64)
    # short-block pair permutation: traversal sfb -> window -> line
    perm = []
    for sfb in range(13):
        for w in range(3):
            for line in range(int(sfb_s[sfb]), int(sfb_s[sfb + 1])):
                perm.append(3 * line + w)
    perm = np.array(perm, np.int32)
    # region-0 boundary in permuted pair space: sfbs with start < 12
    r0_pairs = sum(3 * (int(sfb_s[s + 1]) - int(sfb_s[s])) // 2
                   for s in range(13) if sfb_s[s] < 12)
    # short-band gain matrix in PERMUTED line order: row q maps the
    # (band, window) amplification to permuted position q, so the
    # searches can track the permuted spectrum with a matmul instead
    # of a per-iteration 576-gather
    oh_sp = np.zeros((576, 36))
    for q in range(576):
        line = int(perm[q]) // 3
        w = int(perm[q]) % 3
        for band in range(12):
            if sfb_s[band] <= line < sfb_s[band + 1]:
                oh_sp[q, band * 3 + w] = 1.0
    # per-sfb amplification one-hot for xr updates
    return dict(sfb_l=np.asarray(sfb_l), sfb_s=np.asarray(sfb_s),
                oh_l=oh_l, bw_l=bw_l, oh_s=oh_s, bw_s=bw_s,
                perm_short=perm, r0_pairs_short=r0_pairs,
                oh_s_perm=oh_sp,
                lsf=(version != mpeg.MPEG1))


# ---------------------------------------------------------------------------
# quantize + run length + bit count
# ---------------------------------------------------------------------------

def quantize(xr_abs, qss):
    """ix = round((|xr| 2^{-s/4})^0.75 - 0.0946); xr_abs (G,576),
    qss (G,). True values (no pow_nint saturation)."""
    istep = jnp.exp2(-0.25 * qss)[:, None]
    v = xr_abs * istep
    ix = jnp.floor(jnp.power(v, 0.75) - 0.0946 + 0.5)
    return jnp.maximum(ix, 0.0).astype(jnp.int32)


def quantize_pow75(xr75, qss):
    """quantize() with |xr|^0.75 precomputed: (|xr| 2^{-s/4})^0.75 =
    xr75 * 2^{-3s/16}.  The stepsize searches evaluate dozens of
    candidate stepsizes per granule; hoisting the signal pow out of
    the walk replaces a 576-wide transcendental per step with one
    multiply."""
    istep75 = jnp.exp2(-0.1875 * qss)[:, None]
    ix = jnp.floor(xr75 * istep75 - 0.0946 + 0.5)
    return jnp.maximum(ix, 0.0).astype(jnp.int32)


def calc_runlen(ix, is_short):
    """count1, big_values (loop.c:1488-1519) via max-index reductions.

    Pair-exact reformulation of the reference's sample walk: with
    p_nz = last pair with any nonzero component and p_big = last pair
    with a component > 1, the trailing <=1 run spans p_nz - p_big
    pairs, count1 = that // 2 quads (identical to the reference's
    sample-granular R // 4 for both parities), and big_values covers
    everything below.  Two cheap max reductions -- no suffix scans."""
    G = ix.shape[0]
    pairs = ix.reshape(G, 288, 2)
    idx = jnp.arange(288)[None, :]
    pnz = jnp.any(pairs != 0, axis=2)
    p_nz = jnp.max(jnp.where(pnz, idx, -1), axis=1)
    pbig = jnp.any(pairs > 1, axis=2)
    p_big = jnp.max(jnp.where(pbig, idx, -1), axis=1)
    count1 = (p_nz - p_big) // 2
    big_values = p_nz + 1 - 2 * count1
    count1 = jnp.where(is_short, 0, count1)
    big_values = jnp.where(is_short, 288, big_values)
    return count1.astype(jnp.int32), big_values.astype(jnp.int32)


def subdivide(big_values, is_short, is_short_block, ST):
    """region counts + addresses (loop.c:1638-1703), vectorized.

    For big_values==0 the production path uses zero addresses (no
    phantom stale-state bits).  Returns r0, r1, a1, a2 (a3 == 2*bv)."""
    sfb_l = jnp.asarray(ST["sfb_l"])
    bvr = 2 * big_values
    scfb_anz = jnp.sum(sfb_l[None, :] < bvr[:, None], axis=1)
    subdv = jnp.asarray(mpeg.SUBDV_TABLE)
    r0_init = subdv[jnp.clip(scfb_anz, 0, 22), 0]
    r1_init = subdv[jnp.clip(scfb_anz, 0, 22), 1]
    # decrement r while sfb_l[r+1] > bvr (r down to 0):
    # fits0[g, r] = sfb_l[r+1] <= bvr
    fits0 = sfb_l[None, jnp.arange(22) + 1] <= bvr[:, None]
    cand0 = jnp.where((jnp.arange(22)[None, :] <= r0_init[:, None]) & fits0,
                      jnp.arange(22)[None, :], 0)
    r0 = jnp.max(cand0, axis=1)
    # r1: index = r0 + r + 2
    r_idx = jnp.arange(22)[None, :]
    gather_idx = jnp.clip(r0[:, None] + r_idx + 2, 0, 22)
    fits1 = jnp.take(sfb_l, gather_idx) <= bvr[:, None]
    cand1 = jnp.where((r_idx <= r1_init[:, None]) & fits1, r_idx, 0)
    r1 = jnp.max(cand1, axis=1)
    a1 = jnp.take(sfb_l, jnp.clip(r0 + 1, 0, 22))
    a2 = jnp.take(sfb_l, jnp.clip(r0 + r1 + 2, 0, 22))
    a1 = jnp.minimum(a1, bvr)
    a2 = jnp.minimum(jnp.maximum(a2, a1), bvr)
    # window-switched non-short (start/stop) blocks (loop.c:1694-1701)
    ws = is_short_block & (~is_short)
    r0 = jnp.where(ws, 7, r0)
    r1 = jnp.where(ws, 13, r1)
    a1 = jnp.where(ws, jnp.minimum(jnp.take(sfb_l, 8), bvr), a1)
    a2 = jnp.where(ws, bvr, a2)
    # short blocks: fixed region counts (loop.c:1686-1692)
    r0 = jnp.where(is_short, 8, r0)
    r1 = jnp.where(is_short, 36, r1)
    z = big_values == 0
    return (jnp.where(z, 0, r0).astype(jnp.int32),
            jnp.where(z, 0, r1).astype(jnp.int32),
            jnp.where(z, 0, a1).astype(jnp.int32),
            jnp.where(z, 0, a2).astype(jnp.int32))


_PAIR_BITS = HUFF.pair_bits.astype(np.float32)        # (32, 256)
_C1_HLEN = np.stack([HUFF.count1_hlen(0), HUFF.count1_hlen(1)]).astype(np.float32)
_FIRST = FIRST_TABLE_FOR_MAX
_ESC_A = ESC_TABLE_A
_ESC_B = ESC_TABLE_B


def _region_table_bits(ixp, a1, a2, bvr, is_short, r0_pairs_short):
    """Per-region per-table bit totals + per-region max value.

    ixp: quantized batch ALREADY in traversal order (short granules
    permuted sfb->window->line).  Returns bits_tab (G, 3, 32),
    mx (G, 3).

    The 256-class pair histogram is FACTORIZED into its x/y 16-class
    components: H[g, r, a, b] = sum_p regmask[g,p,r] ohx[g,p,a]
    ohy[g,p,b], computed as (regmask x ohx) -> (G, 288, 48) int8, then
    one int8 contraction over pairs.  An unfactorized (G, 288, 256)
    one-hot costs ~2 GB of HBM traffic per evaluation at G=8k -- the
    dominant rate-loop cost; the factored form moves ~8x less and is
    exactly equal (verified): every count is an exact int32 sum.
    """
    G = ixp.shape[0]
    pairs = ixp.reshape(G, 288, 2)
    x = pairs[:, :, 0]
    y = pairs[:, :, 1]
    xc = jnp.minimum(x, 15)
    yc = jnp.minimum(y, 15)
    pos2 = 2 * jnp.arange(288)[None, :]
    long_region = jnp.where(pos2 < a1[:, None], 0,
                  jnp.where(pos2 < a2[:, None], 1, 2))
    long_valid = pos2 < bvr[:, None]
    short_region = jnp.where(jnp.arange(288)[None, :] < r0_pairs_short, 0, 1)
    region = jnp.where(is_short[:, None], short_region, long_region)
    valid = jnp.where(is_short[:, None], True, long_valid)
    regmask = (jax.nn.one_hot(region, 3, dtype=jnp.int8)
               * valid[:, :, None].astype(jnp.int8))     # (G, 288, 3)
    ohx = jax.nn.one_hot(xc, 16, dtype=jnp.int8)
    ohy = jax.nn.one_hot(yc, 16, dtype=jnp.int8)
    W = (regmask[:, :, :, None] * ohx[:, :, None, :]).reshape(G, 288, 48)
    hist = jnp.einsum("gpq,gpb->gqb", W, ohy,
                      preferred_element_type=jnp.int32) \
        .reshape(G, 3, 256)                              # exact counts
    # HIGHEST precision: a reduced-precision f32 matmul (TF32 on a GPU)
    # rounds products like 13*27 and yields off-by-one BIT COUNTS -- an
    # undercounted part2_3_length overruns the granule in every
    # decoder.  Exact f32 keeps all products (<2^15) integral.
    bits_tab = jnp.einsum("grc,tc->grt", hist.astype(jnp.float32),
                          jnp.asarray(_PAIR_BITS),
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
    # extra linbits for values beyond the LUT clip: LUT charges linbits
    # once per clipped-15 component; true emission also uses linbits
    # (fixed width) so the count is exact as long as value-15 <= linmax,
    # enforced by the table choice below.
    pmax = jnp.maximum(x, y)
    mx = jnp.max(regmask.astype(jnp.int32) * pmax[:, :, None], axis=1) \
        .astype(jnp.int32)
    return bits_tab, mx


def _choose_tables(bits_tab, mx):
    """new_choose_table candidate logic (loop.c:1793-1899), branchless.
    bits_tab (G,3,32), mx (G,3) -> table (G,3), bits (G,3)."""
    first = jnp.asarray(_FIRST)[jnp.clip(mx, 0, 14)]
    esc_a = jnp.asarray(_ESC_A)[jnp.clip(mx - 15, 0, 8192)]
    esc_b = jnp.asarray(_ESC_B)[jnp.clip(mx - 15, 0, 8192)]

    def bt(t):
        return jnp.take_along_axis(bits_tab, t[..., None], axis=-1)[..., 0]

    # small-value path with the reference's pairwise candidate tries
    c = first
    s = bt(c)
    for base, cands in ((2, (3,)), (5, (6,)), (7, (8, 9)), (10, (11, 12)), (13, (15,))):
        for alt in cands:
            altb = bits_tab[..., alt]
            better = (first == base) & (altb <= s)
            c = jnp.where(better, alt, c)
            s = jnp.where(better, altb, s)
    # ESC path
    sa = bt(esc_a)
    sb = bt(esc_b)
    esc_c = jnp.where(sb < sa, esc_b, esc_a)
    esc_s = jnp.minimum(sa, sb)
    c = jnp.where(mx >= 15, esc_c, c)
    s = jnp.where(mx >= 15, esc_s, s)
    c = jnp.where(mx == 0, 0, c)
    s = jnp.where(mx == 0, 0.0, s)
    return c.astype(jnp.int32), s


def _count1_bits(ix, big_values, count1):
    """count1 region bits + table select (loop.c:1531-1590).

    The quad region starts at 2*big_values, which is only 2-aligned;
    shift odd-pair-count granules left by 2 so quads are 4-aligned."""
    G = ix.shape[0]
    start = 2 * big_values
    mis = (start % 4) != 0
    ixs = jnp.where(mis[:, None], jnp.roll(ix, -2, axis=1), ix)
    start = jnp.where(mis, start - 2, start)
    quads = jnp.minimum(ixs, 1).reshape(G, 144, 4)
    # CONFORMANCE (round 5, found by libmpg123 cross-decode): the quad
    # table index is (v<<3)|(w<<2)|(x<<1)|y with v = FIRST sample.  The
    # reference's l3bitstream.c:740 builds p = v|(w<<1)|(x<<2)|(y<<3)
    # -- its count1 quads decode SAMPLE-REVERSED in every conforming
    # decoder (verified: reading dist10's own streams with v-at-bit-3
    # matches mpg123; v-at-bit-0 does not).  The production path uses
    # the conformant index; the byte-exact oracle keeps the
    # reference's quirk for the golden diffs.
    p = (8 * quads[:, :, 0] + 4 * quads[:, :, 1] + 2 * quads[:, :, 2]
         + quads[:, :, 3])
    q4 = 4 * jnp.arange(144)[None, :]
    inr = (q4 >= start[:, None]) & (q4 < (start + 4 * count1)[:, None])
    onehot = jax.nn.one_hot(p, 16, dtype=jnp.int8) * inr[:, :, None].astype(jnp.int8)
    hist = onehot.sum(axis=1, dtype=jnp.int32).astype(jnp.float32)  # (G, 16)
    signbits = jnp.sum(jnp.minimum(ixs.reshape(G, 144, 4), 1) * inr[:, :, None], axis=(1, 2))
    # HIGHEST precision: exact integer-valued f32 products (see
    # _region_table_bits -- a reduced-precision matmul corrupts counts)
    with jax.default_matmul_precision("highest"):
        b0 = hist @ jnp.asarray(_C1_HLEN[0]) + signbits
        b1 = hist @ jnp.asarray(_C1_HLEN[1]) + signbits
    sel = jnp.where(b0 < b1, 0, 1).astype(jnp.int32)
    return jnp.where(sel == 0, b0, b1), sel


def count_all(ix, is_short, is_short_block, ST, pre_permuted=False):
    """Full noiseless-coding analysis of a quantized batch.

    pre_permuted: ix is already in traversal order (the searches hoist
    the short-block permutation out of the per-candidate loop by
    permuting xr75 once -- quantization is elementwise so it commutes).
    count1/big_values only matter for long granules, where permuted ==
    unpermuted, so every quantity below is permutation-independent.

    Returns dict: bits (G,), count1, big_values, r0, r1, a1, a2,
    table_select (G,3), count1table_select (G,), ix_max (G,)."""
    if pre_permuted:
        ixp = ix
    else:
        ixp = jnp.where(is_short[:, None],
                        ix[:, jnp.asarray(ST["perm_short"])], ix)
    count1, big_values = calc_runlen(ixp, is_short)
    r0, r1, a1, a2 = subdivide(big_values, is_short, is_short_block, ST)
    bits_tab, mx = _region_table_bits(ixp, a1, a2, 2 * big_values,
                                      is_short, ST["r0_pairs_short"])
    c1_bits, c1_sel = _count1_bits(ixp, big_values, count1)
    tables, region_bits = _choose_tables(bits_tab, mx)
    # short blocks only use regions 0/1
    region_ok = jnp.where(is_short[:, None],
                          jnp.arange(3)[None, :] < 2,
                          jnp.ones((1, 3), bool))
    bigv_bits = jnp.sum(region_bits * region_ok, axis=1)
    tables = (tables * region_ok).astype(jnp.int32)
    return dict(bits=bigv_bits + c1_bits, count1=count1,
                big_values=big_values, r0=r0, r1=r1, a1=a1, a2=a2,
                table_select=tables, count1table_select=c1_sel,
                ix_max=jnp.max(ixp, axis=1))


# ---------------------------------------------------------------------------
# distortion + allowed distortion
# ---------------------------------------------------------------------------

_POW43 = POW_4_3.astype(np.float32)


@exact_matmuls
def calc_noise(xr_abs, ix, qss, is_short, ST):
    """Per-sfb quantization noise (loop.c:1007-1070).
    Returns xfsf_l (G,21), xfsf_s (G,12,3)."""
    G = xr_abs.shape[0]
    step = jnp.exp2(0.25 * qss)[:, None]
    dq = jnp.power(ix.astype(jnp.float32), 4.0 / 3.0) * step
    err2 = (xr_abs - dq) ** 2
    xfsf_l = (err2 @ jnp.asarray(ST["oh_l"], err2.dtype)) / jnp.asarray(ST["bw_l"], err2.dtype)
    e3 = err2.reshape(G, 192, 3)
    xfsf_s = jnp.einsum("gls,lb->gbs", e3, jnp.asarray(ST["oh_s"], err2.dtype)) \
        / jnp.asarray(ST["bw_s"], err2.dtype)[None, :, None]
    return xfsf_l, xfsf_s


@exact_matmuls
def calc_xmin(xr_abs, ratio_l, ratio_s, ST):
    """Allowed distortion (loop.c:1085-1119)."""
    G = xr_abs.shape[0]
    en2 = xr_abs * xr_abs
    en_l = (en2 @ jnp.asarray(ST["oh_l"], en2.dtype)) / jnp.asarray(ST["bw_l"], en2.dtype)
    xmin_l = ratio_l * en_l
    e3 = en2.reshape(G, 192, 3)
    en_s = jnp.einsum("gls,lb->gbs", e3, jnp.asarray(ST["oh_s"], en2.dtype)) \
        / jnp.asarray(ST["bw_s"], en2.dtype)[None, :, None]
    xmin_s = ratio_s * en_s
    return xmin_l, xmin_s


def quantanf_init(xr_abs):
    """SFM-based initial stepsize (loop.c:369-402)."""
    nz = xr_abs != 0.0
    tpd = jnp.where(nz, xr_abs * xr_abs, 1.0)
    sum1 = jnp.sum(jnp.where(nz, jnp.log(tpd), 0.0), axis=1)
    sum2 = jnp.sum(jnp.where(nz, tpd, 0.0), axis=1)
    sfm = jnp.exp(sum1 / 576.0) / jnp.maximum(sum2 / 576.0, 1e-30)
    tp = jnp.round(8.0 * jnp.log(sfm))
    tp = jnp.maximum(tp, -100.0)
    return jnp.where(sum2 > 0, tp - 70.0, -70.0)


# ---------------------------------------------------------------------------
# scalefactor bit accounting
# ---------------------------------------------------------------------------

def scale_bitcount(sf_l, sf_s, is_short, skip_mask=None):
    """MPEG-1 scalefac_compress selection (loop.c:792-856).
    skip_mask (G, 21): long sfbs whose scalefactors are NOT transmitted
    (scfsi bands copied from granule 0; loop.c:731-790 excludes them
    from part2_length).  Returns compress (G,), part2 (G,),
    overflow (G,)."""
    max1_l = jnp.max(sf_l[:, :11], axis=1)
    max2_l = jnp.max(sf_l[:, 11:21], axis=1)
    max1_s = jnp.max(sf_s[:, :6, :], axis=(1, 2))
    max2_s = jnp.max(sf_s[:, 6:12, :], axis=(1, 2))
    max1 = jnp.where(is_short, max1_s, max1_l)
    max2 = jnp.where(is_short, max2_s, max2_l)
    pow2 = jnp.asarray([1, 2, 4, 8, 16])
    s1 = jnp.asarray(mpeg.SLEN1_TAB)
    s2 = jnp.asarray(mpeg.SLEN2_TAB)
    fits = (max1[:, None] < pow2[s1][None, :]) & (max2[:, None] < pow2[s2][None, :])
    k = jnp.argmax(fits, axis=1)
    overflow = ~jnp.any(fits, axis=1)
    slen1 = s1[k]
    slen2 = s2[k]
    n1 = jnp.full_like(slen1, 11)
    n2 = jnp.full_like(slen2, 10)
    if skip_mask is not None:
        n1 = n1 - jnp.sum(skip_mask[:, :11], axis=1)
        n2 = n2 - jnp.sum(skip_mask[:, 11:21], axis=1)
    part2_l = n1 * slen1 + n2 * slen2
    part2_s = 18 * slen1 + 18 * slen2
    part2 = jnp.where(is_short, part2_s, part2_l)
    return k.astype(jnp.int32), part2.astype(jnp.int32), overflow


def scale_bitcount_lsf(sf_l, sf_s, is_short, preflag):
    """MPEG-2 LSF slen/scalefac_compress selection (loop.c:871-993),
    batched.  Non-intensity channels use table_number 0 (2 with
    preflag); rows 0 (long) / 1 (short); no mixed blocks."""
    G = sf_l.shape[0]

    def pmax_long(parts):
        outs, s = [], 0
        for p in range(4):
            e = s + int(parts[p])
            outs.append(jnp.max(sf_l[:, s:e], axis=1) if e > s
                        else jnp.zeros(G, sf_l.dtype))
            s = e
        return jnp.stack(outs, axis=1)

    def pmax_short(parts):
        outs, s = [], 0
        for p in range(4):
            e = s + int(parts[p]) // 3
            outs.append(jnp.max(sf_s[:, s:e, :], axis=(1, 2)) if e > s
                        else jnp.zeros(G, sf_s.dtype))
            s = e
        return jnp.stack(outs, axis=1)

    NR = mpeg.NR_OF_SFB_BLOCK
    pre = (preflag == 1)
    m_t0 = jnp.where(is_short[:, None], pmax_short(NR[0][1]),
                     pmax_long(NR[0][0]))
    m_t2 = jnp.where(is_short[:, None], pmax_short(NR[2][1]),
                     pmax_long(NR[2][0]))
    max_sfac = jnp.where(pre[:, None], m_t2, m_t0)        # (G, 4)
    maxtab = jnp.where(pre[:, None],
                       jnp.asarray(mpeg.MAX_SFAC_TAB[2])[None, :],
                       jnp.asarray(mpeg.MAX_SFAC_TAB[0])[None, :])
    overflow = jnp.any(max_sfac > maxtab, axis=1)
    slen = jnp.asarray(mpeg.LOG2_TAB)[jnp.clip(max_sfac, 0, 15)]
    compress0 = (((slen[:, 0] * 5 + slen[:, 1]) << 4)
                 + (slen[:, 2] << 2) + slen[:, 3])
    compress2 = 500 + slen[:, 0] * 3 + slen[:, 1]
    compress = jnp.where(pre, compress2, compress0)
    slots_t0 = jnp.where(is_short[:, None], jnp.asarray(NR[0][1])[None],
                         jnp.asarray(NR[0][0])[None])
    slots_t2 = jnp.where(is_short[:, None], jnp.asarray(NR[2][1])[None],
                         jnp.asarray(NR[2][0])[None])
    slots = jnp.where(pre[:, None], slots_t2, slots_t0)
    part2 = jnp.sum(slen * slots, axis=1)
    return compress.astype(jnp.int32), part2.astype(jnp.int32), overflow


# ---------------------------------------------------------------------------
# stepsize search + outer loop
# ---------------------------------------------------------------------------

def _bits_at(xr75p, qss, is_short, is_short_block, ST):
    """Bits + full counts at a stepsize.  xr75p is the PERMUTED
    |xr|^0.75 (short granules in traversal order) -- the permutation
    is hoisted out of the search loops; quantization commutes with it.
    The counts are permutation-independent (see count_all)."""
    ixp = quantize_pow75(xr75p, qss)
    c = count_all(ixp, is_short, is_short_block, ST, pre_permuted=True)
    fits_range = c["ix_max"] <= IXMAX
    bits = jnp.where(fits_range, c["bits"], 1e9)
    return bits, c


def _bits_only(xr75p, qss, is_short, is_short_block, ST):
    """Bit count at a candidate stepsize, nothing else.  The search
    loops below carry ONLY (G,) vectors: when ix and the count dict are
    threaded through lax.while_loop carries, every iteration rewrites
    ~80 MB of HBM for the jnp.where merges; with scalar-per-lane
    carries the whole quantize+histogram pipeline runs without
    materializing anything."""
    bits, _ = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    return bits


# NEGATIVE RESULT (earlier accelerator): a candidate-ladder search --
# one _bits_only-style evaluation scoring K=17 stepsizes per lane by
# folding candidates into the lane axis, replacing the 8-step bisection
# with 2 ladder passes and each warm walk with 1 -- lost end to end.
# When the serial evaluations are THROUGHPUT-bound rather than
# latency-bound, K-parallel scoring costs ~K serial steps, and the
# ladder's 2x17+6x16 lane-evaluations exceed the serial scheme's ~28.
# Whether the GPU is throughput- or latency-bound here is not measured.


def search_walk(xr75p, budget, start_qss, is_short, is_short_block, ST,
                max_steps=40):
    """Walk from a warm start: up while over budget (after scalefactor
    amplification the feasible stepsize only increases -- the reference
    resumes its inner loop the same way, loop.c:580), then refine DOWN
    while a finer stepsize still fits -- the warm start can otherwise
    strand budget that a finer global quantization would spend.
    Bits-only carries; counts are materialized once at the accepted
    stepsize."""
    qss = start_qss
    bits = _bits_only(xr75p, qss, is_short, is_short_block, ST)

    def body(carry):
        qss, bits, it = carry
        bad = bits > budget
        qss2 = jnp.where(bad, qss + 1.0, qss)
        b2 = _bits_only(xr75p, qss2, is_short, is_short_block, ST)
        return qss2, jnp.where(bad, b2, bits), it + 1

    def cond(carry):
        _, bits, it = carry
        return jnp.any(bits > budget) & (it < max_steps)

    qss, bits, _ = jax.lax.while_loop(cond, body, (qss, bits, 0))
    bits, c = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    return qss, bits, c


def search_stepsize(xr75p, budget, qanf, is_short, is_short_block, ST,
                    n_bisect=8, qss_lo=None):
    """Find an integer stepsize with bits <= budget via bisection on
    [lo, QMAX] plus a monotone fix-up; returns (qss, bits, counts).
    All loops carry (G,) vectors only (see _bits_only).

    qss_lo: optional warm lower bound -- the final encode's budget is
    never above the demand encode's (4095), so the accepted demand
    stepsize bounds the final one from below and the bisection starts
    in a much tighter interval.  n_bisect=8 covers the full 255-step
    global_gain range; residual non-monotonicity is handled by the
    fix-up and refinement walks either way."""
    lo = jnp.maximum(qanf, QMIN)          # may violate budget
    if qss_lo is not None:
        lo = jnp.maximum(lo, qss_lo)
    hi = jnp.full_like(lo, QMAX)          # always fits (all-zero ix)

    def body(_, carry):
        lo, hi = carry
        mid = jnp.floor((lo + hi) * 0.5)
        bits = _bits_only(xr75p, mid, is_short, is_short_block, ST)
        ok = bits <= budget
        return jnp.where(ok, lo, mid), jnp.where(ok, mid, hi)

    lo, hi = jax.lax.fori_loop(0, n_bisect, body, (lo, hi))
    qss = hi
    bits = _bits_only(xr75p, qss, is_short, is_short_block, ST)

    # safety walk upward for any residual non-monotonicity
    def fix_body(carry):
        qss, bits, it = carry
        bad = bits > budget
        qss2 = jnp.where(bad, qss + 1.0, qss)
        b2 = _bits_only(xr75p, qss2, is_short, is_short_block, ST)
        return qss2, jnp.where(bad, b2, bits), it + 1

    def fix_cond(carry):
        _, bits, it = carry
        return jnp.any(bits > budget) & (it < 40)

    qss, bits, _ = jax.lax.while_loop(fix_cond, fix_body, (qss, bits, 0))

    # downward refinement: bisection can overshoot on non-monotone
    # regions; take finer steps while they still fit the budget
    def down_body(carry):
        qss, bits, it = carry
        qss2 = qss - 1.0
        b2 = _bits_only(xr75p, qss2, is_short, is_short_block, ST)
        good = (b2 <= budget) & (qss2 >= jnp.maximum(qanf, QMIN))
        return (jnp.where(good, qss2, qss), jnp.where(good, b2, bits),
                it + 1)

    def down_cond(carry):
        return carry[2] < 3

    qss, bits, _ = jax.lax.while_loop(down_cond, down_body, (qss, bits, 0))
    bits, c = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    return qss, bits, c


def _bshape(mask, v):
    extra = v.ndim - 1
    return mask.reshape(mask.shape + (1,) * extra)


_PRETAB = mpeg.PRETAB.astype(np.float32)
# python floats (weak-typed): np.float64 scalars would promote the
# whole spectrum chain to f64 under jax_enable_x64 (the oracle/tests
# run with x64 on), silently doubling every search's memory traffic
_SQRT2 = float(np.sqrt(2.0))
_SQRT2_75 = float(np.sqrt(2.0) ** 0.75)


def _default_max_iter():
    """Outer distortion-loop cap (MP3TPU_MAX_ITER).  Swept on the
    quality fixtures: decoded SNR is flat or IMPROVES as the cap drops
    from 10 to 3 (late amplification rounds trade global quantizer
    precision for per-band resolution the SNR never recovers), while
    each round costs a full-batch search.  Default 6 keeps the
    psychoacoustic amplification mechanism meaningful (most granules
    converge in 3-6 rounds, loop.c:415-558) at ~60% of the cap-10
    cost; it is NOT pushed lower because the SNR metric undervalues
    the noise-shaping the loop exists to do."""
    import os
    return int(os.environ.get("MP3TPU_MAX_ITER", "6"))


@exact_matmuls
def outer_loop(xr, budget, ratio_l, ratio_s, is_short_block, block_type,
               ST, max_iter=None, sf_fix_mask=None, sf_fix_val=None,
               sf_skip_mask=None, qss_lo=None):
    # max_iter=10: decoded SNR on every quality fixture is unchanged
    # vs 24 (the last amplification rounds only juggle bits between
    # already-converged bands), and the whole batch pays for the
    # slowest granule's iterations.
    """Distortion-control loop (loop.c:415-558), batched & masked.

    xr: (G, 576) signed spectrum; budget: (G,) max_bits.
    sf_fix_mask/sf_fix_val (G, 21): long sfbs whose scalefactors are
    FIXED (scfsi: granule 1 reuses granule 0's values, loop.c:320-333
    amp copy/prevent logic) -- the spectrum is pre-amplified by the
    fixed values, amplification never touches those bands, and their
    bits are excluded from part2 (they are not transmitted).
    Returns dict of per-granule coding decisions.
    """
    if max_iter is None:
        max_iter = _default_max_iter()
    G = xr.shape[0]
    is_short = is_short_block & (block_type == 2)
    xr_abs = jnp.abs(xr)
    nonsilent = jnp.max(xr_abs, axis=1) > 0.0
    xmin_l, xmin_s = calc_xmin(xr_abs, ratio_l, ratio_s, ST)
    # long path zeroes the short xmin and vice versa via sfb maxima
    qanf = quantanf_init(xr_abs)

    # derive zero-inits from varying inputs so the carries keep the
    # same sharding "varying" type under shard_map
    zi = (budget * 0).astype(jnp.int32)
    sf_l0 = (xr[:, :21] * 0).astype(jnp.int32)
    sf_s0 = (xr[:, :36] * 0).reshape(G, 12, 3).astype(jnp.int32)
    oh_l = jnp.asarray(ST["oh_l"], xr.dtype)
    oh_s = jnp.asarray(ST["oh_s"], xr.dtype)

    fixed = None
    if sf_fix_mask is not None:
        fixed = sf_fix_mask & (~is_short)[:, None]
        fv = jnp.where(fixed, sf_fix_val, 0).astype(jnp.int32)
        sf_l0 = sf_l0 + fv
        # pre-amplify the spectrum by the fixed scalefactors
        # (ifqstep = sqrt(2) at scalefac_scale 0).  Lines outside any
        # sfb (the 418..575 "sfb21" region) must keep gain 1 -- the
        # one-hot matmul alone would zero them.
        gain = 1.0 + jnp.einsum(
            "lb,gb->gl", oh_l,
            jnp.power(_SQRT2, fv.astype(xr.dtype)) - 1.0)
        xr_abs = jnp.where((~is_short)[:, None], xr_abs * gain, xr_abs)
        xmin_l = xmin_l * jnp.power(2.0, fv.astype(xr.dtype))

    # scfsi: amplification is prevented on FIXED bands of both
    # granules (sf_fix_mask), but only granule 1's bands are skipped
    # from transmission (sf_skip_mask) -- granule 0 still sends them
    skip = None
    if sf_skip_mask is not None:
        skip = sf_skip_mask & (~is_short)[:, None]

    def sbc(sf_l, sf_s, preflag):
        if ST["lsf"]:
            return scale_bitcount_lsf(sf_l, sf_s, is_short, preflag)
        return scale_bitcount(sf_l, sf_s, is_short, skip_mask=skip)

    perm = jnp.asarray(ST["perm_short"])
    oh_sp = jnp.asarray(ST["oh_s_perm"], xr.dtype)        # (576, 36)

    def iter_body(state):
        (xr_a, xr75, xr75p, xmin_l, xmin_s, sf_l, sf_s, preflag,
         qss_prev, done, filling, fill_rounds, it, best) = state
        compress, part2, overflow = sbc(sf_l, sf_s, preflag)
        huff = jnp.maximum(budget - part2, 0)
        qss, bits, c = search_walk(
            xr75p, huff.astype(xr.dtype), qss_prev, is_short,
            is_short_block, ST)
        ix = quantize_pow75(xr75, qss)
        xfsf_l, xfsf_s = calc_noise(xr_a, ix, qss, is_short, ST)

        # retain the latest encoding as current best (reference keeps
        # the last iteration's quantization and pre-amp scalefactors);
        # in the budget-FILL phase (below), accept only results that
        # spend strictly more of the granted bits
        used_new = (part2 + bits).astype(jnp.int32)
        new_best = dict(ix=ix, qss=qss, bits=bits, part2=part2,
                        compress=compress, sf_l=sf_l, sf_s=sf_s,
                        preflag=preflag, used=used_new,
                        count1=c["count1"], big_values=c["big_values"],
                        r0=c["r0"], r1=c["r1"], a1=c["a1"], a2=c["a2"],
                        table_select=c["table_select"],
                        count1table_select=c["count1table_select"])
        upd = (~done) & ((~filling) | (used_new > best["used"]))
        best = {k: jnp.where(_bshape(upd, best[k]), new_best[k], best[k])
                for k in best}
        upd = ~done

        # preemphasis (long only, once).  NOTE: every line-gain below
        # is built as 1 + oh @ (band_gain - 1): lines outside any sfb
        # (418..575, no scalefactor exists) must keep gain 1 -- a bare
        # one-hot matmul zeroes them, which silently erased the whole
        # top spectrum of any granule that amplified even once.
        over_hi = jnp.sum((xfsf_l[:, 17:21] > xmin_l[:, 17:21]), axis=1)
        trigger_pre = (~is_short) & (preflag == 0) & (over_hi == 4) & upd
        pre_gain = jnp.asarray(_SQRT2 ** _PRETAB, xr.dtype)
        pre_gain75 = jnp.asarray((_SQRT2 ** _PRETAB) ** 0.75, xr.dtype)
        xr_a = jnp.where(trigger_pre[:, None],
                         xr_a * (1.0 + oh_l @ (pre_gain - 1.0)), xr_a)
        xr75 = jnp.where(trigger_pre[:, None],
                         xr75 * (1.0 + oh_l @ (pre_gain75 - 1.0)), xr75)
        # preemphasis is long-only, where xr75p == xr75 line for line
        xr75p = jnp.where(trigger_pre[:, None],
                          xr75p * (1.0 + oh_l @ (pre_gain75 - 1.0)),
                          xr75p)
        xmin_l = jnp.where(trigger_pre[:, None],
                           xmin_l * (jnp.asarray(_SQRT2 ** (2 * _PRETAB), xr.dtype)),
                           xmin_l)
        preflag = jnp.where(trigger_pre, 1, preflag)
        # recompute noise after preemphasis like the reference does not
        # (it amplifies using the pre-preemphasis xfsf) -- keep order.

        # amplify distorted bands by sqrt(2); xmin doubles accordingly
        over_l = (xfsf_l > xmin_l) & (~is_short)[:, None] & upd[:, None]
        if fixed is not None:
            over_l = over_l & ~fixed
        over_s = (xfsf_s > xmin_s) & is_short[:, None, None] & upd[:, None, None]

        # ---- budget FILL (no reference counterpart -- the reference
        # stops here and stuffs the slack away).  A budget-limited
        # granule about to terminate (nothing left to amplify, or the
        # next round would amplify every band -- the reference's
        # loop_break exit) with a large unspent bit gap switches to
        # SELECTIVE amplification: only its k most noise/threshold-
        # distorted bands, k sized to the slack, so the extra precision
        # lands inside the stranded bits instead of overshooting.
        # Best-tracking above only accepts fill-mode results that spend
        # strictly more bits, so an overshoot can never regress.
        over_any_real = jnp.any(over_l, axis=1) | jnp.any(over_s, axis=(1, 2))
        amped_or_over_l = (sf_l[:, :21] > 0) | over_l
        if fixed is not None:
            amped_or_over_l = amped_or_over_l | fixed
        prosp_stop = jnp.where(
            is_short,
            jnp.all((sf_s > 0) | over_s, axis=(1, 2)),
            jnp.all(amped_or_over_l, axis=1)) | (~over_any_real)
        slack = budget - used_new.astype(budget.dtype)
        # at most 2 fill rounds per lane: nearly all of the recoverable
        # slack lands in the first rounds, and every extra round keeps
        # the whole batch's while_loop alive.  Silent granules are
        # excluded (their p23 is forced to 0; amplifying zeros would
        # only grow a phantom part2).
        fillable = (budget < 4000.0) & (slack > 32.0) & (fill_rounds < 2) \
            & nonsilent
        filling = filling | (upd & prosp_stop & fillable & (~overflow))
        use_subset = filling & upd & fillable
        fill_rounds_next = fill_rounds + use_subset.astype(jnp.int32)
        k = jnp.clip((slack / 40.0).astype(jnp.int32), 1, 20)
        ratio_fill_l = xfsf_l / jnp.maximum(xmin_l, 1e-30)
        thresh_l = jnp.take_along_axis(
            jnp.sort(ratio_fill_l, axis=1)[:, ::-1], (k - 1)[:, None],
            axis=1)
        topk_l = ratio_fill_l >= thresh_l
        if fixed is not None:
            topk_l = topk_l & ~fixed
        over_l = jnp.where((use_subset & (~is_short))[:, None],
                           topk_l, over_l)
        ratio_fill_s = (xfsf_s / jnp.maximum(xmin_s, 1e-30)).reshape(G, 36)
        thresh_s = jnp.take_along_axis(
            jnp.sort(ratio_fill_s, axis=1)[:, ::-1],
            jnp.clip(k, 1, 35)[:, None], axis=1)
        topk_s = (ratio_fill_s >= thresh_s).reshape(G, 12, 3)
        over_s = jnp.where((use_subset & is_short)[:, None, None],
                           topk_s, over_s)
        sf_l = sf_l + over_l.astype(jnp.int32)
        sf_s = sf_s + over_s.astype(jnp.int32)
        xmin_l = jnp.where(over_l, xmin_l * 2.0, xmin_l)
        xmin_s = jnp.where(over_s, xmin_s * 2.0, xmin_s)
        amp_l = (over_l.astype(xr.dtype) * (_SQRT2 - 1.0)).astype(xr.dtype)
        amp_l75 = (over_l.astype(xr.dtype) * (_SQRT2_75 - 1.0)).astype(xr.dtype)
        gain_long = 1.0 + jnp.einsum("lb,gb->gl", oh_l, amp_l)
        gain_long75 = 1.0 + jnp.einsum("lb,gb->gl", oh_l, amp_l75)
        xr_a = jnp.where((~is_short)[:, None], xr_a * gain_long, xr_a)
        xr75 = jnp.where((~is_short)[:, None], xr75 * gain_long75, xr75)
        xr75p = jnp.where((~is_short)[:, None], xr75p * gain_long75,
                          xr75p)
        amp_s = (over_s.astype(xr.dtype) * (_SQRT2 - 1.0)).astype(xr.dtype)  # (G,12,3)
        amp_s75 = (over_s.astype(xr.dtype) * (_SQRT2_75 - 1.0)).astype(xr.dtype)
        gain_s = 1.0 + jnp.einsum("lb,gbs->gls", oh_s, amp_s).reshape(G, 576)
        gain_s75 = 1.0 + jnp.einsum("lb,gbs->gls", oh_s, amp_s75).reshape(G, 576)
        xr_a = jnp.where(is_short[:, None], xr_a * gain_s, xr_a)
        xr75 = jnp.where(is_short[:, None], xr75 * gain_s75, xr75)
        # permuted-order short gain via the precomputed line map
        gain_sp75 = 1.0 + jnp.einsum(
            "qB,gB->gq", oh_sp, amp_s75.reshape(G, 36))
        xr75p = jnp.where(is_short[:, None], xr75p * gain_sp75, xr75p)

        over_any = jnp.any(over_l, axis=1) | jnp.any(over_s, axis=(1, 2))
        qss_prev = qss  # warm start for the next iteration
        amped_l = (sf_l[:, :21] > 0) if fixed is None \
            else ((sf_l[:, :21] > 0) | fixed)
        all_amped = jnp.where(is_short,
                              jnp.all(sf_s > 0, axis=(1, 2)),
                              jnp.all(amped_l, axis=1))
        _, _, overflow2 = sbc(sf_l, sf_s, preflag)
        # fill-mode lanes run until the slack is spent (or the round
        # cap / sf-field overflow / max_iter); others stop at the
        # reference's exits
        done = done | overflow2 | jnp.where(
            filling, (slack <= 32.0) | (fill_rounds_next >= 2),
            (~over_any) | all_amped)
        return (xr_a, xr75, xr75p, xmin_l, xmin_s, sf_l, sf_s, preflag,
                qss_prev, done, filling, fill_rounds_next, it + 1, best)

    def iter_cond(state):
        done = state[9]
        it = state[12]
        return (~jnp.all(done)) & (it < max_iter)

    bits0 = budget * 0
    best0 = dict(ix=(xr * 0).astype(jnp.int32), qss=qanf, bits=bits0,
                 part2=zi, compress=zi, sf_l=sf_l0, sf_s=sf_s0,
                 preflag=zi, used=zi, count1=zi, big_values=zi,
                 r0=zi, r1=zi, a1=zi, a2=zi,
                 table_select=(xr[:, :3] * 0).astype(jnp.int32),
                 count1table_select=zi)
    # initial full bisection once, outside the loop; iterations warm-walk
    xr75_0 = jnp.power(xr_abs, 0.75)
    xr75p_0 = jnp.where(is_short[:, None], xr75_0[:, perm], xr75_0)
    qss_init, _, _ = search_stepsize(
        xr75p_0, budget.astype(xr.dtype), qanf, is_short, is_short_block,
        ST, qss_lo=qss_lo)
    state = (xr_abs, xr75_0, xr75p_0, xmin_l, xmin_s, sf_l0, sf_s0,
             zi, qss_init, zi > 1, zi > 1, zi, 0, best0)
    state = jax.lax.while_loop(iter_cond, iter_body, state)
    best = state[13]
    silent = jnp.max(jnp.abs(xr), axis=1) == 0.0
    p23 = (best["part2"] + best["bits"]).astype(jnp.int32)
    out = dict(best)
    out.pop("used")
    # iteration-0 stepsize: a sound warm lower bound for a LATER encode
    # of the same spectrum at an equal-or-smaller budget (the
    # post-amplification best["qss"] is NOT -- amplification can push
    # it above what the final encode's fixed scalefactors need)
    out["qss0"] = qss_init
    out["part2_3_length"] = jnp.where(silent, 0, p23)
    out["global_gain"] = jnp.where(
        silent, 210, jnp.round(best["qss"] + 210.0).astype(jnp.int32))
    out["block_type"] = block_type
    out["window_switching_flag"] = is_short_block.astype(jnp.int32)
    return out
