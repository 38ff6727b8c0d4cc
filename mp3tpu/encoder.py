"""High-level encoder: fast mode (production path).

Pipeline per clip -- one uninterrupted device program chain, ONE host
sync (see encode_layer3_fast):

  analyze + demand encode (per super-chunk segment, FSM/halo carried)
    -> device reservoir budget scan (ops/jaxresv.py)
    -> final encode + on-device bit packing (warm-started from the
       demand stepsizes)
    -> single download -> host guard validation + native C++ assembly.

StreamEncoder runs the same pipeline window by window with carried
state (bit-identical to one-shot) and checkpoints to a small dict.

The exact byte-replica of the reference lives in mp3tpu.numpy_ref and
is used by tests; this path trades bit-identity for speed and fixes
the reference's quantizer saturation (better decoded SNR everywhere).
"""
import numpy as np

from .config import EncoderConfig
from .models import layer3
from .runtime import profiling
from .tables import layer12 as T12
from .tables import mpeg


#: chunk-size buckets (granules per channel per dispatch) for the
#: multi-chip path: each device carries chunks of the smallest bucket
#: covering its share, so at most len(CHUNK_BUCKETS) programs compile.
CHUNK_BUCKETS = (64, 128, 256)

#: super-chunk buckets for the single-chip path.  The per-segment
#: pipeline overlaps each segment's upload / compute / threaded
#: download, so the top bucket trades batch efficiency against
#: pipeline depth (not yet swept on the GPU).  A clip is decomposed
#: greedily into full buckets largest-first plus one final remainder
#: padded to the smallest covering bucket; at most len(SUPER_BUCKETS)
#: programs per phase ever compile.  Override: MP3TPU_SUPER=a,b,c.
SUPER_BUCKETS = (256, 1024, 2048)


def _super_buckets():
    """Resolved super-chunk buckets: MP3TPU_SUPER=a,b,c overrides the
    default for EVERY consumer (one-shot, corpus, streaming remainder,
    tools) so a sweep measures one consistent configuration."""
    import os
    env = os.environ.get("MP3TPU_SUPER")
    if env:
        return tuple(sorted(int(x) for x in env.split(",")))
    return SUPER_BUCKETS


def _chunk_size(G):
    import os
    env = os.environ.get("MP3TPU_CHUNK")
    if env:
        return int(env)
    for c in CHUNK_BUCKETS:
        if G <= c:
            return c
    return CHUNK_BUCKETS[-1]


def _stitch_flat(plan, seg_sides, seg_flats, nch, lane0=0, G=None):
    """Stitch per-segment device-compacted payloads into one clip-order
    flat buffer + per-granule word offsets for the native assembler.

    seg_sides: per segment (n_lanes*n_pad, 19) side tables (p23 at col
    0); seg_flats: per segment (cap,) u32 flat payloads in lane order
    (jaxbits.compact_payload).  A clip's channel lanes are contiguous
    granule ranges, so each (segment, channel) contributes ONE
    contiguous word span; the clip layout is channel-major like the
    native side table.

    lane0: the clip's first channel lane within the segment lane axis
    (0 for the single-clip path; b*nch for corpus groups that stack
    clips as extra lanes).  G: the clip's real granule count when it is
    SHORTER than the plan's coverage (corpus clips below the group
    max).  Tail granules past G are excluded from spans AND offsets
    together -- they are NOT reliably silent (the MDCT overlap of the
    last real granule rings into the first padded granule, giving it a
    nonzero p23), so trimming only the offsets would shift every later
    channel's words.
    Returns (clip_flat u32, offsets (nch*G,) int64)."""
    spans = [[] for _ in range(nch)]
    for (pos, n_real, n_pad), side_s, flat in zip(plan, seg_sides,
                                                  seg_flats):
        clip_n = n_real if G is None else max(0, min(n_real, G - pos))
        if clip_n == 0:
            continue
        p23 = np.asarray(side_s)[:, 0].astype(np.int64)
        wlen = (p23 + 31) >> 5
        end = np.cumsum(wlen)
        off = end - wlen
        flat = np.asarray(flat)
        for ch in range(nch):
            lo = (lane0 + ch) * n_pad
            spans[ch].append((flat[off[lo]:end[lo + clip_n - 1]],
                              wlen[lo:lo + clip_n]))
    pieces = [p for ch in range(nch) for p, _ in spans[ch]]
    wlens = [w for ch in range(nch) for _, w in spans[ch]]
    clip_flat = (np.concatenate(pieces) if pieces
                 else np.zeros(0, np.uint32))
    wlen_clip = np.concatenate(wlens)
    offs = np.cumsum(wlen_clip) - wlen_clip
    return clip_flat, offs.astype(np.int64)


def _plan_segments(G, buckets=None):
    """Greedy super-chunk plan: [(start, n_real, n_padded)] -- full
    largest-bucket segments plus ONE remainder padded to the smallest
    covering bucket.  buckets=None resolves MP3TPU_SUPER / the default.

    Minimizing SEGMENT COUNT rather than padding: each segment pays the
    rate loop's serial search latency, which barely grows with batch
    size while the device has spare width, so padded lanes ride along
    almost for free (splitting the remainder into exact small buckets
    was slower on the first accelerator).  Only the last segment is
    ever padded, so the carried FSM/halo state always comes from real
    granules."""
    import os
    if buckets is None:
        buckets = _super_buckets()
    plan = []
    pos = 0
    big = buckets[-1]
    # pipeline ramp: a small FIRST segment shortens the lead-in (the
    # pipeline's only un-overlapped upload) when the clip spans
    # multiple big buckets.  MP3TPU_RAMP=0 disables; value = ramp size
    # (must be one of the buckets).
    ramp = int(os.environ.get("MP3TPU_RAMP", str(buckets[0])))
    if ramp in buckets and ramp < big and G > big + ramp:
        plan.append((0, ramp, ramp))
        pos = ramp
    while G - pos > big:
        plan.append((pos, big, big))
        pos += big
    rem = G - pos
    for b in buckets:
        if rem <= b:
            return plan + [(pos, rem, b)]
    return plan + [(pos, rem, big)]


def encode_layer3_fast(pcm, cfg: EncoderConfig, prof=None, chunk=None):
    """Encode int16 PCM to MP3 bytes via the device path.

    The whole pipeline is ONE uninterrupted device program chain with a
    single host sync:

      1. device: <=2 large analyze+demand dispatches (psy + filterbank
         + MDCT + rate loop at the unconstrained budget 4095), FSM and
         halo state carried between them;
      2. device: the exact reservoir scan (reservoir.c:101-134 policy)
         as a lax.scan (ops/jaxresv.py) assigns budgets with usage
         predicted as min(demand, budget - delta) -- exact for every
         granule the reservoir leaves unconstrained;
      3. device: one final encode+pack dispatch per segment at the
         assigned budgets, scfsi pairs fixed to their demand
         scalefactors; emission + bit packing on device (ops/jaxbits);
      4. host:   ONE sync drains side+payload+scan tensors; reservoir
         guard validates the realized p23 chain (clamp + re-encode only
         on the rare overdraw) + native assembly.
    """
    import jax
    import jax.numpy as jnp

    from . import ensure_compile_cache
    ensure_compile_cache()
    prof = prof if prof is not None else profiling.from_env()
    cfg.finalize()
    assert cfg.layer == 3
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    nch = cfg.nchannels
    assert pcm.shape[0] == nch
    spf = cfg.samples_per_frame
    mode_gr = cfg.mode_gr
    nframes = int(np.ceil(pcm.shape[1] / spf))
    total = nframes * spf
    pcm = np.pad(pcm, ((0, 0), (0, total - pcm.shape[1])))
    G = nframes * mode_gr
    sfreq_hz = float(mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]) * 1000.0
    sfb_s = mpeg.sfb_short(cfg.version, cfg.sampling_frequency)

    # float-input sanitization: NaN -> 0, +/-Inf -> full scale (the
    # int16 cast of non-finite values is otherwise undefined)
    if not np.issubdtype(np.asarray(pcm).dtype, np.integer):
        pcm = np.clip(np.nan_to_num(pcm, nan=0.0, posinf=32767.0,
                                    neginf=-32768.0), -32768, 32767)
    blocks = pcm.astype(np.int16).reshape(nch, G, 576)
    plan = _plan_segments(G, (chunk,) if chunk else None)
    assert all(s % 2 == 0 or mode_gr == 1 for _, _, s in plan)

    whole_spf, _ = cfg.slots_per_frame()
    bits_per_frame = 8 * whole_spf
    sideinfo_len = mpeg.sideinfo_bits(cfg.version, nch, cfg.error_protection)
    mean_bits = (bits_per_frame - sideinfo_len) // mode_gr
    # main_data_begin is 9 bits in MPEG-1, 8 in LSF (reservoir.c:53-62)
    resv_limit = 4088 if mode_gr == 2 else 2040
    resv_max = min(max(0, 7680 - bits_per_frame), resv_limit)
    import os
    delta = int(os.environ.get("MP3TPU_RELAX_DELTA", "28"))
    pw = int(os.environ.get("MP3TPU_PW", "96"))

    from concurrent.futures import ThreadPoolExecutor

    # ---- per-segment pipeline, ONE pass over the plan:
    #   analyze+demand -> causal reservoir scan (carried device level,
    #   reservoir.c:101-134 as a lax.scan) -> final encode+pack, all
    #   async dispatches; then THIS segment's (side, flat payload,
    #   scfsi) download runs on a worker thread while the next
    #   segment's upload/compute proceeds.  device_get releases the
    #   GIL, so the wall-clock approaches max(upload stream, compute)
    #   + last download instead of their sum.  The scan tensors (target/
    #   demand) stay ON DEVICE -- only the rare guard-retry/re-bucket
    #   paths download them.
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        return _encode_layer3_pipeline(
            pool, plan, blocks, cfg, nch, mode_gr, nframes, G, total,
            sfreq_hz, sfb_s, bits_per_frame, sideinfo_len, mean_bits,
            resv_max, delta, pw, prof)
    finally:
        pool.shutdown(wait=False)


def _encode_layer3_pipeline(pool, plan, blocks, cfg, nch, mode_gr,
                            nframes, G, total, sfreq_hz, sfb_s,
                            bits_per_frame, sideinfo_len, mean_bits,
                            resv_max, delta, pw, prof):
    import jax
    import jax.numpy as jnp

    from .runtime.bitstream import resv_guard

    def _cat(parts):
        """per-segment (nch*n_pad, ...) -> (nch, G, ...) real granules."""
        outs = []
        for (pos, n_real, n_pad), p in zip(plan, parts):
            p = np.asarray(p)
            outs.append(p.reshape((nch, n_pad) + p.shape[1:])[:, :n_real])
        return np.concatenate(outs, axis=1)

    def dispatch_final(a, budget, n_pad, pw):
        cap = layer3.jaxbits.payload_cap_words(
            n_pad // mode_gr, bits_per_frame, sideinfo_len, resv_max,
            nch * n_pad)
        return layer3.encode_final(
            a["xr"], a["ratio_l"], a["ratio_s"], a["block_type"],
            budget, cfg.version, cfg.sampling_frequency,
            payload_words=pw, scfsi=a.get("scfsi"),
            sf_fix=a.get("sf_fix"), nch=nch, qss_lo=a["qss"],
            flat_cap=cap)

    segs, futures = [], []
    fsm = jnp.zeros(nch, jnp.int32)
    # strong-typed int32 so the carried level's dtype matches h["size"]
    # on later segments (a weak-typed Python 0 double-compiled the
    # fused program per bucket)
    size = jnp.int32(0)
    with prof.stage("pipeline dispatch+fetch (device)"):
        for pos, n_real, n_pad in plan:
            bl = np.zeros((nch, 4 + n_pad, 576), np.int16)
            if pos:
                bl[:, :4] = blocks[:, pos - 4: pos]
            bl[:, 4:4 + n_real] = blocks[:, pos: pos + n_real]
            cap = layer3.jaxbits.payload_cap_words(
                n_pad // mode_gr, bits_per_frame, sideinfo_len,
                resv_max, nch * n_pad)
            # ONE fused program per segment (analyze+scan+final): one
            # dispatch per segment, and the carried fsm/size stay
            # device scalars
            h = layer3.encode_segment_fused(
                bl, fsm, size, cfg.version, cfg.sampling_frequency,
                sfreq_hz, pw, nch, cap, n_real, mean_bits, resv_max,
                mode_gr, delta)
            fsm = h["fsm_state"]
            size = h["size"]
            # retain ONLY what the (rare) re-bucket/guard-retry paths
            # read -- keeping side/payload too would pin every
            # segment's device buffers for the whole clip
            segs.append({k: h[k] for k in
                         ("xr", "ratio_l", "ratio_s", "block_type",
                          "qss", "target", "demand", "scfsi", "sf_fix")
                         if k in h})
            futures.append(pool.submit(
                jax.device_get,
                (h["side"], h["payload"], h.get("scfsi"),
                 h["n_nonfinite"])))
        got = [f.result() for f in futures]

    side = _cat([g[0] for g in got])
    payload = _stitch_flat(plan, [g[0] for g in got],
                           [g[1] for g in got], nch)
    if mode_gr == 2:
        scfsi_frames = np.concatenate(
            [np.asarray(g[2])[:, :n_real // 2]
             for (pos, n_real, n_pad), g in zip(plan, got)],
            axis=1)                                   # (nch, F, 4)
    else:
        scfsi_frames = np.zeros((nch, nframes, 4), np.int32)
    n_nonfinite = int(sum(int(g[3]) for g in got))

    target = demand = None

    def fetch_scan():
        """Lazy download of the scan tensors (retry paths only).  The
        fused program returns them at the padded width; slice to each
        segment's real granules before concatenating."""
        nonlocal target, demand
        if target is None:
            td = jax.device_get([(s["target"], s["demand"])
                                 for s in segs])
            target = np.concatenate(
                [np.asarray(t)[:, :n_real]
                 for (pos, n_real, n_pad), (t, _) in zip(plan, td)],
                axis=1).astype(np.int64)
            demand = np.concatenate(
                [np.asarray(d)[:, :n_real]
                 for (pos, n_real, n_pad), (_, d) in zip(plan, td)],
                axis=1).astype(np.int64)
        return target, demand

    def run_final(pw, label, target=None, demand=None):
        with prof.stage(label):
            futs = []
            for (pos, n_real, n_pad), s in zip(plan, segs):
                bh = np.full((nch, n_pad), 4095.0, np.float32)
                t = target[:, pos: pos + n_real]
                d = demand[:, pos: pos + n_real]
                bh[:, :n_real] = np.where(t < d, t, 4095)
                h = dispatch_final(s, jnp.asarray(bh.reshape(-1)),
                                   n_pad, pw)
                futs.append(pool.submit(jax.device_get,
                                        (h["side"], h["payload"])))
            got = [f.result() for f in futs]
        return (_cat([g[0] for g in got]),
                _stitch_flat(plan, [g[0] for g in got],
                             [g[1] for g in got], nch))

    # the dense encode is the authority on p23:
    # (a) a granule can exceed its payload-word bucket -> silent
    #     truncation in the splice; detect and re-bucket wider;
    # (b) the reservoir guard can flag an overdraw; clamp budgets
    #     (floored -- a tiny frame's limit could otherwise go <= 0)
    #     and re-encode.
    p23 = side[:, :, 0].astype(np.int64)
    while int(p23.max()) > 32 * pw:
        assert pw < layer3.jaxbits.PAYLOAD_WORDS, \
            "granule exceeds the maximum payload row"
        pw = min(layer3.jaxbits.PAYLOAD_WORDS, pw + 32)
        target, demand = fetch_scan()
        side, payload = run_final(pw, "final re-bucket (device)",
                                  target=target, demand=demand)
        p23 = side[:, :, 0].astype(np.int64)
    for _retry in range(4):
        bad, limits = resv_guard(p23, nframes, nch, mean_bits, resv_max,
                                 mode_gr)
        if not bad:
            break
        if _retry == 3:
            raise RuntimeError(
                "reservoir guard failed on a guaranteed-feasible clamp")
        from .runtime.bitstream import guard_clamp
        target, demand = fetch_scan()
        target = guard_clamp(target, limits, _retry, mean_bits, nch)
        side, payload = run_final(pw, "final encode+pack retry (device)",
                                  target=target, demand=demand)
        p23 = side[:, :, 0].astype(np.int64)

    out = _marshal_and_assemble(cfg, side, payload, nframes,
                                bits_per_frame, mean_bits, resv_max,
                                sfb_s, prof, scfsi=scfsi_frames)
    # per-encode metrics (SURVEY.md section 5.5): the reference prints
    # avg slots/bitrate at exit (musicin.c:807-811); here every encode
    # reports a structured dict on the profiler sink
    secs = total / (sfreq_hz * 1.0)
    prof.meta.update(
        frames=nframes, bytes=len(out), audio_s=round(secs, 3),
        kbps=round(len(out) * 8 / max(secs, 1e-9) / 1000.0, 2),
        segments=len(plan), guard_retries=_retry,
        nonfinite_granules=n_nonfinite,
        mean_p23=float(p23.mean()), resv_delta=delta)
    return out


class StreamEncoder:
    """Streaming Layer III encoder: O(window) memory for an unbounded
    PCM stream (the reference reads stdin frame by frame,
    musicin.c:310-312 + encode.c:123-168; here the unit is a
    fixed-size granule window so every device program is reused).

    All carried state is tiny and explicit: 4 halo PCM blocks, the
    (nch,) FSM state, two reservoir levels (the scan's predictive
    chain and the realized chain), and the native assembler's weave
    state -- so the whole-clip scan/guard/assembly are reproduced
    window by window exactly (the reservoir recurrences are causal),
    and the whole thing `checkpoint()`s to a small dict from which
    `resume()` continues with the identical output stream.
    """

    def __init__(self, cfg: EncoderConfig, window=None, prof=None):
        import os

        import jax.numpy as jnp

        from . import ensure_compile_cache
        ensure_compile_cache()
        if window is None:
            # default to the one-shot plan's top bucket so remainder
            # windows decompose exactly like the one-shot path (a
            # fixed 4096 silently diverged when the bucket default
            # changed to 2048 in round 5)
            window = _super_buckets()[-1]
        self.prof = prof if prof is not None else profiling.from_env()
        cfg.finalize()
        assert cfg.layer == 3
        self.cfg = cfg
        self.window = window
        self.nch = cfg.nchannels
        self.spf = cfg.samples_per_frame
        self.mode_gr = cfg.mode_gr
        self.sfreq_hz = float(
            mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]) * 1000.0
        whole_spf, _ = cfg.slots_per_frame()
        self.bits_per_frame = 8 * whole_spf
        sideinfo_len = mpeg.sideinfo_bits(cfg.version, self.nch,
                                          cfg.error_protection)
        self.mean_bits = (self.bits_per_frame - sideinfo_len) // self.mode_gr
        resv_limit = 4088 if self.mode_gr == 2 else 2040
        self.resv_max = min(max(0, 7680 - self.bits_per_frame), resv_limit)
        self.delta = int(os.environ.get("MP3TPU_RELAX_DELTA", "28"))
        self.pw = int(os.environ.get("MP3TPU_PW", "96"))
        # remainder windows pad exactly like the one-shot plan so the
        # two paths run the SAME device programs (bit-identity)
        _sb = _super_buckets()
        self.rem_buckets = _sb if window == _sb[-1] else (window,)

        from .runtime.bitstream import NativeAssembler
        sfb_s = mpeg.sfb_short(cfg.version, cfg.sampling_frequency)
        self.asm = NativeAssembler(cfg, np.asarray(sfb_s, np.int32))
        self.fsm = jnp.zeros(self.nch, jnp.int32)
        self.halo4 = np.zeros((self.nch, 4, 576), np.int16)
        # strong-typed like the one-shot path so both hit the SAME
        # compiled fused program (predictive reservoir chain)
        self.scan_size = jnp.int32(0)
        self.real_size = 0        # realized chain (guard + assembler)
        self.buf = np.zeros((self.nch, 0), np.int16)

    def feed(self, piece):
        """Accept PCM (int16, (n,) mono or (n, nch)); returns any MP3
        bytes whose frames completed."""
        piece = np.atleast_2d(np.asarray(piece, np.int16))
        # orient by channel count, not by comparing dims: a final
        # (nch, 1) chunk must NOT be transposed
        if piece.shape[0] != self.nch:
            piece = piece.T
        assert piece.shape[0] == self.nch, piece.shape
        self.buf = np.concatenate([self.buf, piece], axis=1)
        out = []
        ws = self.window * 576
        while self.buf.shape[1] >= ws:
            out.append(self._encode_window(self.buf[:, :ws], False))
            self.buf = self.buf[:, ws:]
        return b"".join(out)

    def finish(self):
        """Flush: encode the remaining samples (decomposed exactly like
        the one-shot remainder plan) and close the stream on the CBR
        grid."""
        if self.buf.shape[1]:
            total = -(-self.buf.shape[1] // self.spf) * self.spf
            pcm_r = np.pad(self.buf,
                           ((0, 0), (0, total - self.buf.shape[1])))
            self.buf = np.zeros((self.nch, 0), np.int16)
            plan = _plan_segments(total // 576, self.rem_buckets)
            out = []
            for i, (pos, n_real, _) in enumerate(plan):
                out.append(self._encode_window(
                    pcm_r[:, pos * 576:(pos + n_real) * 576],
                    i == len(plan) - 1))
            return b"".join(out)
        return self.asm.finish()

    def checkpoint(self):
        """Small serializable dict: resume() continues the stream with
        byte-identical output (SURVEY.md section 5.4 -- the reference
        has nothing; the CBR layout makes the carry a few KB)."""
        return dict(
            fsm=np.asarray(self.fsm), halo4=self.halo4.copy(),
            scan_size=int(np.asarray(self.scan_size)),
            real_size=self.real_size,
            buf=self.buf.copy(), asm=self.asm.checkpoint())

    @classmethod
    def resume(cls, cfg, ckpt, window=None, prof=None):
        import jax.numpy as jnp
        enc = cls(cfg, window=window, prof=prof)
        enc.fsm = jnp.asarray(ckpt["fsm"])
        enc.halo4 = ckpt["halo4"].copy()
        enc.scan_size = jnp.int32(ckpt["scan_size"])
        enc.real_size = int(ckpt["real_size"])
        enc.buf = ckpt["buf"].copy()
        enc.asm.restore(ckpt["asm"])
        return enc

    def _encode_window(self, pcm_w, is_last):
        import jax
        import jax.numpy as jnp

        from .runtime.bitstream import resv_guard

        cfg, nch, prof = self.cfg, self.nch, self.prof
        mode_gr = self.mode_gr
        G = pcm_w.shape[1] // 576
        n_pad = (G if G == self.window
                 else _plan_segments(G, self.rem_buckets)[0][2])
        blocks = pcm_w.reshape(nch, G, 576)
        bl = np.zeros((nch, 4 + n_pad, 576), np.int16)
        bl[:, :4] = self.halo4
        bl[:, 4:4 + G] = blocks
        cap = layer3.jaxbits.payload_cap_words(
            n_pad // mode_gr, self.bits_per_frame,
            mpeg.sideinfo_bits(cfg.version, nch, cfg.error_protection),
            self.resv_max, nch * n_pad)
        # the SAME fused program as the one-shot pipeline (analyze +
        # reservoir scan + final encode+pack), so stream/one-shot
        # bit-identity holds by construction, not by hoping XLA
        # compiles split and fused graphs to identical floats
        with prof.stage("stream segment (fused)"):
            h = layer3.encode_segment_fused(
                bl, self.fsm, self.scan_size, cfg.version,
                cfg.sampling_frequency, self.sfreq_hz, self.pw, nch,
                cap, G, self.mean_bits, self.resv_max, mode_gr,
                self.delta)
            self.fsm = h["fsm_state"]
            self.scan_size = h["size"]
        self.halo4 = blocks[:, -4:] if G >= 4 else np.concatenate(
            [self.halo4[:, G - 4:], blocks], axis=1)

        def cut(a):
            a = np.asarray(a)
            return a.reshape((nch, n_pad) + a.shape[1:])[:, :G]

        nframes_w = G // mode_gr

        def run_final(pw, label, target, demand):
            bh = np.full((nch, n_pad), 4095.0, np.float32)
            bh[:, :G] = np.where(target < demand, target, 4095)
            budget = jnp.asarray(bh.reshape(-1))
            with prof.stage(label):
                hh = layer3.encode_final(
                    h["xr"], h["ratio_l"], h["ratio_s"],
                    h["block_type"], budget,
                    cfg.version, cfg.sampling_frequency,
                    payload_words=pw, scfsi=h.get("scfsi"),
                    sf_fix=h.get("sf_fix"), nch=nch,
                    qss_lo=h["qss"], flat_cap=cap)
                got = jax.device_get([hh["side"], hh["payload"]])
            payload = _stitch_flat([(0, G, n_pad)], [got[0]], [got[1]],
                                   nch)
            return cut(got[0]), payload

        pw = self.pw
        with prof.stage("stream fetch"):
            got = jax.device_get(
                (h["side"], h["payload"], h.get("scfsi"),
                 h["target"], h["demand"]))
        side = cut(got[0])
        payload = _stitch_flat([(0, G, n_pad)], [got[0]], [got[1]], nch)
        target = np.asarray(got[3])[:, :G].astype(np.int64)
        demand = np.asarray(got[4])[:, :G].astype(np.int64)
        if mode_gr == 2:
            scfsi_frames = np.asarray(got[2])[:, :G // 2]
        else:
            scfsi_frames = np.zeros((nch, nframes_w, 4), np.int32)
        p23 = side[:, :, 0].astype(np.int64)
        while int(p23.max()) > 32 * pw:
            pw = min(layer3.jaxbits.PAYLOAD_WORDS, pw + 32)
            side, payload = run_final(pw, "stream re-bucket",
                                      target=target, demand=demand)
            p23 = side[:, :, 0].astype(np.int64)
        for _retry in range(4):
            bad, limits, new_real = resv_guard(
                p23, nframes_w, nch, self.mean_bits, self.resv_max,
                mode_gr, size=self.real_size)
            if not bad:
                break
            if _retry == 3:
                raise RuntimeError("stream reservoir guard failed on a "
                                   "guaranteed-feasible clamp")
            from .runtime.bitstream import guard_clamp
            target = guard_clamp(target, limits, _retry, self.mean_bits,
                                 nch)
            side, payload = run_final(pw, "stream final retry",
                                      target=target, demand=demand)
            p23 = side[:, :, 0].astype(np.int64)
        self.real_size = new_real

        with prof.stage("stream assembly"):
            scfsi_fm = np.ascontiguousarray(
                np.asarray(scfsi_frames, np.int32).transpose(1, 0, 2))
            flat, offs = payload
            self.asm.encode_clip_payload(
                nframes_w, self.bits_per_frame, self.mean_bits,
                self.resv_max, scfsi_fm,
                np.ascontiguousarray(np.asarray(side, np.int32)),
                np.ascontiguousarray(flat), row_offsets=offs)
            return self.asm.finish() if is_last else self.asm.drain()


def encode_layer3_stream(pcm_iter, cfg: EncoderConfig, window=None,
                         prof=None):
    """Generator form of StreamEncoder: consume an iterator of PCM
    pieces, yield MP3 byte chunks as frames complete."""
    enc = StreamEncoder(cfg, window=window, prof=prof)
    for piece in pcm_iter:
        chunk = enc.feed(piece)
        if chunk:
            yield chunk
    tail = enc.finish()
    if tail:
        yield tail


def _marshal_and_assemble(cfg, side, payload, nframes,
                          bits_per_frame, mean_bits, resv_max, sfb_s,
                          prof, scfsi=None):
    """Shared tail of the single-chip and multi-chip Layer III paths:
    the (nch, G, 19) side-info table arrives DEVICE-BUILT in the native
    assembler's layout (models/layer3.pack_state); run the native
    whole-clip assembler (reservoir.c:141-226 frame loop + side-info
    emission + payload splice in one C++ call)."""
    nch = cfg.nchannels
    G = nframes * cfg.mode_gr
    row_offsets = None
    if isinstance(payload, tuple):                # compacted flat form
        payload, row_offsets = payload
    payload = np.ascontiguousarray(payload)
    side = np.ascontiguousarray(np.asarray(side, np.int32))
    assert side.shape == (nch, G, 19), side.shape

    # ---- final exact reservoir + stuffing + payload weave: the whole
    # clip's frame loop (reservoir.c:141-226 + side-info emission)
    # runs in one C++ call; granule main_data arrives pre-packed from
    # the device (ops/jaxbits)
    from .runtime.bitstream import NativeAssembler
    with prof.stage("native assembly"):
        asm = NativeAssembler(cfg, np.asarray(sfb_s, np.int32))
        if scfsi is None:
            scfsi = np.zeros((nch, nframes, 4), np.int32)
        # native layout: (nframes, nch, 4)
        scfsi_fm = np.ascontiguousarray(
            np.asarray(scfsi, np.int32).transpose(1, 0, 2))
        asm.encode_clip_payload(nframes, bits_per_frame, mean_bits,
                                resv_max, scfsi_fm,
                                np.ascontiguousarray(side), payload,
                                row_offsets=row_offsets)
        out = asm.finish()
    return out


def encode_layer12_fast(pcm, cfg: EncoderConfig):
    """Layer I/II device path: filterbank/psy/scale-factors/scfsi/
    quantization (mp3tpu.ops.jaxlayer12), exact vectorized greedy bit
    allocation on host (mp3tpu.runtime.alloc12 -- no cross-frame state,
    all frames in lockstep), vectorized element marshalling, native
    C++ bit packing.

    Deviation from the byte-exact oracle (mp3tpu.numpy_ref.layer12):
    the DSP runs in float32 with jnp.fft instead of the reference's
    float32 split-radix, so allocation can differ on threshold ties;
    streams are always valid and decoded quality is equal.
    """
    import jax.numpy as jnp

    from . import ensure_compile_cache
    ensure_compile_cache()
    from .ops import jaxlayer12 as J
    from .runtime import alloc12
    from .runtime.bitstream import pack_elements

    cfg.finalize()
    layer = cfg.layer
    assert layer in (1, 2)
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    nch = cfg.nchannels
    assert pcm.shape[0] == nch
    sfreq_khz = mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]
    spf = 384 if layer == 1 else 1152
    bits_per_slot = 32 if layer == 1 else 8
    nframes = int(np.ceil(pcm.shape[1] / spf))
    pcm = np.pad(pcm, ((0, 0), (0, nframes * spf - pcm.shape[1])))
    F = nframes
    ngroups = 1 if layer == 1 else 3
    joint = cfg.mode == mpeg.MODE_JOINT

    table, sblimit = T12.pick_table(
        cfg.version, layer, cfg.bitrate_index, cfg.sampling_frequency,
        nch, cfg.bitrate_kbps, float(sfreq_khz))
    whole_spf = int((spf / float(sfreq_khz))
                    * (cfg.bitrate_kbps / float(bits_per_slot)))
    adb = whole_spf * bits_per_slot

    # layer 1 filterbank stream is the PCM delayed by 64 samples
    # (encode.c:221-246; see the oracle)
    if layer == 1:
        fb = np.concatenate([np.zeros((nch, 64), pcm.dtype),
                             pcm[:, :-64]], axis=1)
    else:
        fb = pcm

    ana = J.analyze_frames(jnp.asarray(pcm), jnp.asarray(fb), layer,
                           table, sblimit, nch, F,
                           float(sfreq_khz) * 1000.0)
    if cfg.psy_model == 1:
        from .numpy_ref.tonal import psycho_one_frames
        snr = psycho_one_frames(pcm.astype(np.float64), layer, cfg,
                                np.asarray(ana["sb"]))
    else:
        snr = np.asarray(ana["snr"], np.float64)  # (nch, F, 32)
    scalar = np.asarray(ana["scalar"])            # (nch, F, G, 32)
    scfsi = (np.asarray(ana["scfsi"]) if layer == 2 else None)

    smr = np.empty((F, 2, 32))
    smr[:, 0] = snr[0]
    smr[:, 1] = snr[nch - 1]
    scfsi_fc = None
    if layer == 2:
        scfsi_fc = np.empty((F, 2, 32), np.int64)
        scfsi_fc[:, 0] = scfsi[0]
        scfsi_fc[:, 1] = scfsi[nch - 1]

    # joint mode decision + allocation (host, exact)
    if joint:
        is_js, mode_ext, jsbound = alloc12.joint_mode(
            smr, scfsi_fc, adb, layer, table, nch, cfg.error_protection)
        mode = np.where(is_js, mpeg.MODE_JOINT, mpeg.MODE_STEREO)
    else:
        mode = np.full(F, cfg.mode)
        mode_ext = np.zeros(F, np.int64)
        jsbound = np.full(F, sblimit if layer == 2 else 32)
    ba, adb_left = alloc12.greedy_allocation(
        smr, scfsi_fc, np.full(F, adb), jsbound, layer, table, nch,
        cfg.error_protection)

    # quantization on device: substitute joint samples/scales above
    # jsbound for channel 0's lane (encode.c:1245-1249, 1288-1291)
    sbq = np.asarray(ana["sb"])                   # (nch, F, G, 12, 32)
    js = np.arange(32)[None, :] >= jsbound[:, None]           # (F, 32)
    if joint and nch == 2:
        j_sample = np.asarray(ana["j_sample"])
        j_scale = np.asarray(ana["j_scale"])
        sb0 = np.where(js[:, None, None, :], j_sample, sbq[0])
        sc0 = np.where(js[:, None, :], j_scale, scalar[0])
    else:
        sb0 = sbq[0]
        sc0 = scalar[0]
    quant = J.quantize_l1 if layer == 1 else (
        lambda s, c, b: J.quantize_l2(s, c, b, table))
    codes = [np.asarray(quant(jnp.asarray(sb0), jnp.asarray(sc0),
                              jnp.asarray(ba[:, 0])))]
    if nch == 2:
        codes.append(np.asarray(quant(
            jnp.asarray(sbq[1]), jnp.asarray(scalar[1]),
            jnp.asarray(ba[:, 1]))))
    codes = np.stack(codes).astype(np.int64)      # (nch, F, G, 12, 32)

    elements = _marshal_layer12(cfg, layer, table, sblimit, nch, F,
                                mode, mode_ext, jsbound, ba, scfsi,
                                scalar, codes, adb_left)
    values, lengths = elements
    return pack_elements(values, lengths) + b"\x00"


def encode_layer12_stream(pcm_iter, cfg: EncoderConfig,
                          window_frames=512):
    """O(window) streaming Layer I/II encode: consume an iterator of
    (n,) or (n, nch) int16 PCM pieces, yield MP3 byte chunks.

    The reference streams every layer frame by frame
    (encode.c:123-168); Layer I/II frames are bitstream-independent
    (no back-pointer), so windows of W frames encoded with a 4-frame
    HALO of true history concatenate into the identical stream: every
    cross-frame lookback -- the 512-tap filterbank window, the psy
    analysis window starts (384f-640 / 1152f+576i-480) and the
    unpredictability chain's two-window spectral history -- reaches at
    most 4 frames back, and CBR frames are fixed-size so the halo
    frames' bytes cut exactly.  Byte-identity with the one-shot
    encoder is locked by tests/test_stream.py.
    """
    cfg.finalize()
    assert cfg.layer in (1, 2)
    nch = cfg.nchannels
    spf = 384 if cfg.layer == 1 else 1152
    bits_per_slot = 32 if cfg.layer == 1 else 8
    sfreq_khz = mpeg.S_FREQ_KHZ[cfg.version][cfg.sampling_frequency]
    whole_spf = int((spf / float(sfreq_khz))
                    * (cfg.bitrate_kbps / float(bits_per_slot)))
    frame_bytes = whole_spf * (bits_per_slot // 8)
    HALO_F = 4

    buf = np.zeros((nch, 0), np.int16)
    halo = np.zeros((nch, 0), np.int16)    # grows to HALO_F frames
    ws = window_frames * spf

    def encode_window(pcm_w, halo_w):
        """Encode [halo | window]; return the window frames' bytes."""
        ext = np.concatenate([halo_w, pcm_w], axis=1)
        out = encode_layer12_fast(ext.T, cfg)
        cut = (halo_w.shape[1] // spf) * frame_bytes
        return out[cut:-1]                 # drop halo frames + flush byte

    def step(pcm_w):
        nonlocal halo
        chunk = encode_window(pcm_w, halo)
        keep = min(HALO_F * spf, halo.shape[1] + pcm_w.shape[1])
        halo = np.concatenate([halo, pcm_w], axis=1)[:, -keep:]
        return chunk

    for piece in pcm_iter:
        piece = np.atleast_2d(np.asarray(piece, np.int16))
        if piece.shape[0] != nch:   # never flip a final (nch, 1) chunk
            piece = piece.T
        assert piece.shape[0] == nch, piece.shape
        buf = np.concatenate([buf, piece], axis=1)
        while buf.shape[1] >= ws:
            yield step(buf[:, :ws])
            buf = buf[:, ws:]
    if buf.shape[1]:
        nf = -(-buf.shape[1] // spf)
        yield step(np.pad(buf, ((0, 0), (0, nf * spf - buf.shape[1]))))
    yield b"\x00"                          # the one-shot flush byte


def _marshal_layer12(cfg, layer, table, sblimit, nch, F, mode, mode_ext,
                     jsbound, ba, scfsi, scalar, codes, adb_left):
    """Build the flat (value, length) element stream for all frames,
    fully vectorized.  Element layout per frame (musicin.c:621-705):
    header [crc] bit_alloc [scfsi] scalefactors samples ancillary."""
    js = np.arange(32)[None, :] >= jsbound[:, None]           # (F, 32)
    active = np.arange(32)[None, :] < sblimit                 # (1, 32)

    # --- header word (encode.c:419-438)
    hdr = (0xFFF << 20) | (cfg.version << 19) | ((4 - layer) << 17) \
        | ((0 if cfg.error_protection else 1) << 16) \
        | (cfg.bitrate_index << 12) | (cfg.sampling_frequency << 10) \
        | (0 << 9) | (cfg.extension << 8) \
        | (int(cfg.copyright) << 3) | (int(cfg.original) << 2) \
        | cfg.emphasis
    header = (hdr | (mode.astype(np.int64) << 6)
              | (mode_ext.astype(np.int64) << 4))             # (F,)
    per_frame = [(header[:, None], np.full((F, 1), 32))]

    # --- CRC (common.c:1251-1308); tiny per-frame loop, only if on
    if cfg.error_protection:
        from .numpy_ref.layer12 import _crc_calc
        from .tables import layer12 as T
        alloc = T.ALLOC[table] if layer == 2 else None
        crc = np.zeros(F, np.int64)
        ba2 = ba if nch == 2 else np.repeat(ba[:, :1], 2, axis=1)
        for f in range(F):
            crc[f] = _crc_calc(
                cfg, 0, int(mode[f]), int(mode_ext[f]), ba2[f],
                None if scfsi is None else
                np.stack([scfsi[0][f], scfsi[nch - 1][f]]),
                nch, sblimit, int(jsbound[f]), alloc, layer)
        per_frame.append((crc[:, None], np.full((F, 1), 16)))

    # --- bit allocation: sb outer, ch inner
    nbal = (np.full(32, 4) if layer == 1
            else np.asarray(__import__("mp3tpu.tables.layer12",
                                       fromlist=["x"]).ALLOC[table]["nbal"]))
    bav = np.zeros((F, 32, nch), np.int64)
    bal = np.zeros((F, 32, nch), np.int64)
    for ch in range(nch):
        bav[:, :, ch] = ba[:, ch]
        bal[:, :, ch] = nbal[None, :] * active
    if nch == 2:
        bal[:, :, 1] = np.where(js, 0, bal[:, :, 1])
    per_frame.append((bav.reshape(F, -1), bal.reshape(F, -1)))

    if layer == 2:
        # --- scfsi: sb outer ch inner where ba != 0 (both channels)
        sv = np.zeros((F, 32, nch), np.int64)
        sl = np.zeros((F, 32, nch), np.int64)
        for ch in range(nch):
            sv[:, :, ch] = scfsi[ch]
            sl[:, :, ch] = np.where(ba[:, ch] != 0, 2, 0)
        per_frame.append((sv.reshape(F, -1), sl.reshape(F, -1)))
        # --- scale factors: 3 slots per (sb, ch)
        fv = np.zeros((F, 32, nch, 3), np.int64)
        fl = np.zeros((F, 32, nch, 3), np.int64)
        for ch in range(nch):
            s = scalar[ch]                         # (F, 3, 32)
            sc = scfsi[ch]
            has = ba[:, ch] != 0
            fv[:, :, ch, 0] = s[:, 0]
            fv[:, :, ch, 1] = np.where(sc == 0, s[:, 1], s[:, 2])
            fv[:, :, ch, 2] = s[:, 2]
            fl[:, :, ch, 0] = np.where(has, 6, 0)
            fl[:, :, ch, 1] = np.where(has & (sc != 2), 6, 0)
            fl[:, :, ch, 2] = np.where(has & (sc == 0), 6, 0)
        per_frame.append((fv.reshape(F, -1), fl.reshape(F, -1)))
        # --- samples: t(3) x triple(4) x sb x ch, 3 slots each
        from .tables import layer12 as T
        alloc = T.ALLOC[table]
        grp = alloc["group"][np.arange(32)[None, :], ba]      # (F,ch?,32)
        bits = alloc["bits"][np.arange(32)[None, :], ba]
        steps = alloc["steps"][np.arange(32)[None, :], ba]
        c = codes.transpose(1, 2, 3, 4, 0)         # (F, 3, 12, 32, nch)
        c3 = c.reshape(F, 3, 4, 3, 32, nch)        # triples
        sval = np.zeros((F, 3, 4, 32, nch, 3), np.int64)
        slen = np.zeros((F, 3, 4, 32, nch, 3), np.int64)
        for ch in range(nch):
            g = grp[:, ch]                         # (F, 32)
            b = bits[:, ch]
            y = steps[:, ch]
            has = ba[:, ch] != 0
            grouped = (g == 1) & has
            ungrouped = (g == 3) & has
            s0 = c3[:, :, :, 0, :, ch]
            s1 = c3[:, :, :, 1, :, ch]
            s2 = c3[:, :, :, 2, :, ch]
            gval = s0 + s1 * y[:, None, None, :] + s2 * (y * y)[:, None, None, :]
            sval[:, :, :, :, ch, 0] = np.where(grouped[:, None, None, :],
                                               gval, s0)
            sval[:, :, :, :, ch, 1] = s1
            sval[:, :, :, :, ch, 2] = s2
            ln = b[:, None, None, :]
            slen[:, :, :, :, ch, 0] = np.where(has, b, 0)[:, None, None, :]
            slen[:, :, :, :, ch, 1] = np.where(ungrouped, b, 0)[:, None, None, :]
            slen[:, :, :, :, ch, 2] = np.where(ungrouped, b, 0)[:, None, None, :]
        if nch == 2:
            # above jsbound only channel 0's lane is sent
            slen[:, :, :, :, 1, :] = np.where(
                js[:, None, None, :, None], 0, slen[:, :, :, :, 1, :])
        per_frame.append((sval.reshape(F, -1), slen.reshape(F, -1)))
    else:
        # --- layer 1 scale factors: 1 slot per (sb, ch)
        fv = np.zeros((F, 32, nch), np.int64)
        fl = np.zeros((F, 32, nch), np.int64)
        for ch in range(nch):
            fv[:, :, ch] = scalar[ch][:, 0]
            fl[:, :, ch] = np.where(ba[:, ch] != 0, 6, 0)
        per_frame.append((fv.reshape(F, -1), fl.reshape(F, -1)))
        # --- samples: j(12) x sb x ch, ba+1 bits
        c = codes.transpose(1, 2, 3, 4, 0)[:, 0]   # (F, 12, 32, nch)
        sval = np.zeros((F, 12, 32, nch), np.int64)
        slen = np.zeros((F, 12, 32, nch), np.int64)
        for ch in range(nch):
            sval[:, :, :, ch] = c[:, :, :, ch]
            has = ba[:, ch] != 0
            slen[:, :, :, ch] = np.where(has, ba[:, ch] + 1, 0)[:, None, :]
        if nch == 2:
            slen[:, :, :, 1] = np.where(js[:, None, :], 0, slen[:, :, :, 1])
        per_frame.append((sval.reshape(F, -1), slen.reshape(F, -1)))

    # --- ancillary zero fill, 32-bit chunks
    max_anc = int(adb_left.max()) if F else 0
    nslots = (max_anc + 31) // 32
    if nslots:
        rem = adb_left[:, None] - 32 * np.arange(nslots)[None, :]
        al = np.clip(rem, 0, 32)
        av = np.zeros((F, nslots), np.int64)
        per_frame.append((av, al))

    values = np.concatenate([v for v, _ in per_frame], axis=1)
    lengths = np.concatenate([l for _, l in per_frame], axis=1)
    # mask codes to their field width (quantized codes may carry junk
    # in lanes with ba == 0; lengths are 0 there, but pack masks by
    # length anyway)
    return (values.reshape(-1).astype(np.uint32),
            lengths.reshape(-1).astype(np.int32))
