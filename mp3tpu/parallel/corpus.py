"""Corpus encoding: many clips, one or many hosts.

The reference encodes one file per process invocation (musicin.c:456);
the corpus config in BASELINE.json (1,000 clips) is its natural
production scale-out.  Clips are independent, so the corpus is data
parallel at two levels:

  - within a host: clips run back-to-back through the fixed-size chunk
    programs (mp3tpu/encoder.py) -- after the first clip everything is
    compiled and the device stays busy via async dispatch;
  - across hosts: `jax.distributed` partitions the clip list by
    process id (contiguous shards); there is no cross-host traffic at
    all -- aggregate metrics are reduced host-side by the caller.

For pod-slice scale-out of a SINGLE long clip, use
mp3tpu/parallel/clip.py (chunk-sharded mesh encode) instead.
"""
import time

import numpy as np

from ..config import EncoderConfig


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize jax.distributed (multi-host).  All arguments default
    to the standard JAX env vars; returns (process_id, num_processes)."""
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index(), jax.process_count()


def local_share(n_items, process_id=None, num_processes=None):
    """Contiguous [start, end) range of corpus items owned by this
    process."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    per = -(-n_items // nproc)
    start = min(pid * per, n_items)
    return start, min(start + per, n_items)


_plan_budgets_corpus_impl = None


def _plan_budgets_corpus(pes, p23s, plan, B, nch, mode_gr, mean_bits,
                         resv_max, delta):
    """Corpus-wide budget assignment: every clip's reservoir scan runs
    in ONE vmapped lax.scan dispatch (ops/jaxresv.scan_budgets_batched)
    instead of B serial per-clip dispatches.  pes/p23s: per-segment
    (B*nch*n_pad,) lane arrays.  Returns (per-segment budget rows,
    target (B, nch, G), demand (B, nch, G))."""
    import jax
    import jax.numpy as jnp

    from ..ops import jaxresv

    global _plan_budgets_corpus_impl
    if _plan_budgets_corpus_impl is None:
        from functools import partial as _partial

        @_partial(jax.jit, static_argnames=(
            "plan", "B", "nch", "mode_gr", "mean_bits", "resv_max",
            "delta"))
        def run(pes, p23s, plan, B, nch, mode_gr, mean_bits, resv_max,
                delta):
            parts_pe, parts_dm = [], []
            for (pos, n_real, n_pad), pe_s, dm_s in zip(plan, pes, p23s):
                parts_pe.append(
                    pe_s.reshape(B, nch, n_pad)[:, :, :n_real])
                parts_dm.append(
                    dm_s.reshape(B, nch, n_pad)[:, :, :n_real])
            pe = jnp.concatenate(parts_pe, axis=2)        # (B, nch, G)
            demand = jnp.concatenate(parts_dm, axis=2).astype(jnp.int32)
            gm = jax.vmap(
                lambda x: jaxresv.granule_major(x, nch, mode_gr))
            bud, _ = jaxresv.scan_budgets_batched(
                gm(pe), gm(demand), jnp.zeros(B, jnp.int32), mean_bits,
                resv_max, mode_gr, nch, delta)
            budg = jax.vmap(
                lambda x: jaxresv.from_granule_major(x, nch, mode_gr))(bud)
            target = jnp.minimum(demand, budg)
            rows = []
            for (pos, n_real, n_pad) in plan:
                t = target[:, :, pos:pos + n_real]
                d = demand[:, :, pos:pos + n_real]
                r = jnp.where(t < d, t.astype(jnp.float32), 4095.0)
                r = jnp.pad(r, ((0, 0), (0, 0), (0, n_pad - n_real)),
                            constant_values=4095.0)
                rows.append(r.reshape(-1))
            return tuple(rows), target, demand

        _plan_budgets_corpus_impl = run
    return _plan_budgets_corpus_impl(pes, p23s, plan, B, nch, mode_gr,
                                     mean_bits, resv_max, delta)


def encode_corpus_batched(clips, cfg_kwargs, batch=8, prof=None):
    """Encode many independent same-rate clips by STACKING them as
    extra channel lanes in one device pipeline.

    Channel lanes in the analyzer are fully independent streams, so B
    clips of the same configuration ride one analyze+demand dispatch,
    one final encode+pack dispatch and ONE host sync per group --
    amortizing the per-dispatch and per-sync costs that dominate
    small-clip encodes.  The
    per-clip reservoir scans run on device (ops/jaxresv.py); guard +
    assembly stay per clip on host.  This is the aggregate-throughput
    mode for the BASELINE.json 1,000-clip corpus; for one long clip use
    the mesh path (parallel/clip.py) instead.

    clips: list of (pcm int16, rate); all rates/configs must match.
    Returns (outputs, stats) like encode_corpus."""
    import jax
    import jax.numpy as jnp

    from .. import encoder as E
    from .. import ensure_compile_cache
    from ..models import layer3
    from ..runtime import profiling
    from ..runtime.bitstream import resv_guard
    from ..tables import mpeg

    if prof is None:
        prof = profiling.from_env()
    ensure_compile_cache()

    t0 = time.perf_counter()
    rate = clips[0][1]
    assert all(r == rate for _, r in clips)
    cfg0 = EncoderConfig(sample_rate_hz=rate, **cfg_kwargs)
    cfg0.finalize()
    assert cfg0.layer == 3
    nch = cfg0.nchannels
    mode_gr = cfg0.mode_gr
    spf = cfg0.samples_per_frame
    sfreq_hz = float(
        mpeg.S_FREQ_KHZ[cfg0.version][cfg0.sampling_frequency]) * 1000.0
    sfb_s = mpeg.sfb_short(cfg0.version, cfg0.sampling_frequency)
    whole_spf, _ = cfg0.slots_per_frame()
    bits_per_frame = 8 * whole_spf
    sideinfo_len = mpeg.sideinfo_bits(cfg0.version, nch,
                                      cfg0.error_protection)
    mean_bits = (bits_per_frame - sideinfo_len) // mode_gr
    resv_limit = 4088 if mode_gr == 2 else 2040
    resv_max = min(max(0, 7680 - bits_per_frame), resv_limit)
    import os
    delta = int(os.environ.get("MP3TPU_RELAX_DELTA", "28"))
    pw = int(os.environ.get("MP3TPU_PW", "96"))

    outputs = [None] * len(clips)
    audio_s = 0.0
    # group-level pipelining: each group's device chain is dispatched
    # and its download submitted to a worker thread; the PREVIOUS
    # group's download-wait + per-clip host assembly then overlap the
    # current group's upload/compute (same overlap as the single-clip
    # per-segment pipeline in mp3tpu/encoder.py)
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=2)
    pending = []

    def dispatch_group(g0):
        nonlocal audio_s
        group = clips[g0:g0 + batch]
        B = len(group)
        framed = []
        for pcm, _ in group:
            pcm = np.atleast_2d(np.asarray(pcm, np.int16))
            if pcm.shape[0] > pcm.shape[1]:
                pcm = pcm.T
            assert pcm.shape[0] == nch
            audio_s += pcm.shape[1] / rate
            nf = -(-pcm.shape[1] // spf)
            framed.append((np.pad(pcm, ((0, 0),
                                        (0, nf * spf - pcm.shape[1]))),
                           nf))
        G_max = max(nf for _, nf in framed) * mode_gr
        plan = E._plan_segments(G_max)
        L = B * nch
        blocks = np.zeros((L, G_max, 576), np.int16)
        for b, (pcm, nf) in enumerate(framed):
            blocks[b * nch:(b + 1) * nch, :nf * mode_gr] = \
                pcm.reshape(nch, nf * mode_gr, 576)

        segs = []
        fsm = jnp.zeros(L, jnp.int32)
        for pos, n_real, n_pad in plan:
            bl = np.zeros((L, 4 + n_pad, 576), np.int16)
            if pos:
                bl[:, :4] = blocks[:, pos - 4: pos]
            bl[:, 4:4 + n_real] = blocks[:, pos: pos + n_real]
            ana = layer3.analyze_demand_fused(
                bl, fsm, cfg0.version, cfg0.sampling_frequency, sfreq_hz)
            fsm = ana["fsm_state"]
            segs.append(ana)

        # ALL clips' reservoir scans in ONE vmapped device dispatch
        # (B serial per-clip scans made wide lanes barely pay)
        budgets, tgt_all, dem_all = _plan_budgets_corpus(
            tuple(a["pe"] for a in segs),
            tuple(a["p23"] for a in segs),
            tuple(plan), B, nch, mode_gr, mean_bits, resv_max, delta)

        def final_fetch(budget_per_seg, fetch_aux):
            """Dispatch the group's per-segment final encodes and
            return the device_get fetch list (one dispatch site for
            both the pipelined and the retry path)."""
            hosts = []
            for i, ((pos, n_real, n_pad), a) in enumerate(zip(plan, segs)):
                cap = layer3.jaxbits.payload_cap_words(
                    B * n_pad // mode_gr, bits_per_frame, sideinfo_len,
                    B * resv_max, L * n_pad)
                h = layer3.encode_final(
                    a["xr"], a["ratio_l"], a["ratio_s"],
                    a["block_type"], budget_per_seg[i],
                    cfg0.version, cfg0.sampling_frequency,
                    payload_words=pw, scfsi=a.get("scfsi"),
                    sf_fix=a.get("sf_fix"), nch=L,
                    qss_lo=a["qss"], flat_cap=cap)
                hosts.append(h)
            fetch = [(h["side"], h["payload"]) for h in hosts]
            if fetch_aux:
                fetch.append((tgt_all, dem_all,
                              [a.get("scfsi") for a in segs]))
            return fetch

        def run_final(budget_per_seg, fetch_aux):
            return jax.device_get(final_fetch(budget_per_seg, fetch_aux))

        # pipelined form: the wait happens in collect_group,
        # overlapping the NEXT group's upload/compute
        fut = pool.submit(jax.device_get, final_fetch(budgets, True))
        return lambda: collect_group(g0, fut.result(), framed, plan, B,
                                     L, run_final)

    def collect_group(g0, got, framed, plan, B, L, run_final):
        aux = got[len(plan)]

        def cat_lane(parts, b):
            outs = []
            for (pos, n_real, n_pad), p in zip(plan, parts):
                p = np.asarray(p)
                outs.append(p.reshape((L, n_pad) + p.shape[1:])
                            [b * nch:(b + 1) * nch, :n_real])
            return np.concatenate(outs, axis=1)

        def stitch_clip(got_segs, b, G):
            """Clip b's flat payload + ch-major word offsets via the
            shared helper (encoder._stitch_flat): lane base b*nch,
            trimmed to the clip's real G granules -- spans and offsets
            together, because tail granules past G are NOT reliably
            silent (MDCT overlap ring-down)."""
            return E._stitch_flat(plan, [s for s, _ in got_segs],
                                  [f for _, f in got_segs], nch,
                                  lane0=b * nch, G=G)

        for b, (pcm, nf) in enumerate(framed):
            G = nf * mode_gr
            side = cat_lane([g[0] for g in got[:len(plan)]], b)[:, :G]
            payload = stitch_clip(got[:len(plan)], b, G)
            target = np.asarray(aux[0][b]).astype(np.int64)[:, :G]
            demand = np.asarray(aux[1][b]).astype(np.int64)[:, :G]
            if mode_gr == 2:
                scfsi_frames = np.concatenate(
                    [np.asarray(s).reshape(L, -1, 4)
                     [b * nch:(b + 1) * nch, :n_real // 2]
                     for (pos, n_real, n_pad), s in zip(plan, aux[2])],
                    axis=1)[:, :G // 2]
            else:
                scfsi_frames = np.zeros((nch, nf, 4), np.int32)
            p23 = side[:, :, 0].astype(np.int64)
            for _retry in range(4):
                bad, limits = resv_guard(p23, nf, nch, mean_bits,
                                         resv_max, mode_gr)
                if not bad:
                    break
                assert _retry < 3, "corpus reservoir guard failed"
                from ..runtime.bitstream import guard_clamp
                target = guard_clamp(target, limits, _retry, mean_bits,
                                     nch)
                # rare: re-encode this clip's lanes alone via the
                # single-clip path budgets
                G_max = plan[-1][0] + plan[-1][1]
                bh = np.full((nch, G_max), 4095.0, np.float32)
                bh[:, :G] = np.where(target < demand, target, 4095)
                budgets_b = []
                for (pos, n_real, n_pad) in plan:
                    r = np.full((nch, n_pad), 4095.0, np.float32)
                    r[:, :n_real] = bh[:, pos:pos + n_real]
                    budgets_b.append(r)
                redo = [np.tile(r, (B, 1)).reshape(-1)
                        for r in budgets_b]
                got_b = run_final([jnp.asarray(r) for r in redo], False)
                side = cat_lane([g[0] for g in got_b], b)[:, :G]
                payload = stitch_clip(got_b, b, G)
                p23 = side[:, :, 0].astype(np.int64)
            outputs[g0 + b] = E._marshal_and_assemble(
                cfg0, side, payload, nf, bits_per_frame, mean_bits,
                resv_max, sfb_s, prof, scfsi=scfsi_frames)

    # one-group lookahead: group k+1's uploads/compute run while group
    # k's download completes on the pool thread and its clips assemble
    lookahead = int(os.environ.get("MP3TPU_CORPUS_LOOKAHEAD", "3"))
    try:
        for g0 in range(0, len(clips), batch):
            pending.append(dispatch_group(g0))
            if len(pending) > lookahead:
                pending.pop(0)()
        while pending:
            pending.pop(0)()
    finally:
        pool.shutdown(wait=False)

    wall = time.perf_counter() - t0
    return outputs, dict(clips=len(clips), audio_s=audio_s, wall_s=wall,
                         x_realtime=audio_s / wall if wall else 0.0)


def encode_corpus(clips, cfg_kwargs, encode=None, workers=3):
    """Encode a list of (pcm int16, sample_rate_hz) clips; returns
    (outputs, stats dict).  cfg_kwargs: EncoderConfig kwargs applied
    per clip (sample_rate_hz comes from the clip).

    workers > 1 pipelines clips through a thread pool: one clip's
    host stages (PCM framing, reservoir scan, native assembly -- all
    GIL-releasing numpy/ctypes) overlap another clip's device
    dispatches, so the chip never idles between clips.  Encodes are
    stateless per call; outputs keep corpus order."""
    if encode is None:
        from ..encoder import encode_layer3_fast
        encode = encode_layer3_fast

    def one(item):
        pcm, rate = item
        pcm = np.atleast_2d(pcm)
        cfg = EncoderConfig(sample_rate_hz=rate, **cfg_kwargs)
        return encode(pcm, cfg)

    audio_s = sum(max(np.atleast_2d(p).shape) / r for p, r in clips)
    t0 = time.perf_counter()
    if workers > 1 and len(clips) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as ex:
            outputs = list(ex.map(one, clips))
    else:
        outputs = [one(c) for c in clips]
    wall = time.perf_counter() - t0
    return outputs, dict(clips=len(clips), audio_s=audio_s, wall_s=wall,
                         x_realtime=audio_s / wall if wall else 0.0)
