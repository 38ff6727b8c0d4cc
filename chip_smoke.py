#!/usr/bin/env python3
"""Smoke run on the GPU: the encoder's main paths at full size, each
checked against the repository's own references.

  python chip_smoke.py              every phase below, on one GPU
  python chip_smoke.py --chips 4    only the mesh path over four GPUs,
                                    against the one-GPU encode

Phases, all in this one process (a JAX process reserves most of a
card's memory when it starts, so a second one would fail):

  device    platform, card, power limit, native assembler build
  oneshot   60 s stereo 44.1 kHz 128 kbps through encode_layer3_fast
            (cold and steady time), decoded by mp3tpu.decoder and by
            libmpg123; one Layer II 192 kbps encode of the same clip
  stream    StreamEncoder(window=2048) is byte-identical to
            encode_layer3_fast(chunk=2048)
  fixtures  every Layer III fixture against the reference encoder's
            decoded SNR (tests/golden/ref_snr.json); every Layer I/II
            fixture against its reference stream's SNR
  integers  jaxloop.count_all on the GPU equals the CPU's, G = 4096
  frontend  analyze_granules' spectrum against numpy_ref.dsp (float64)
  corpus    encode_corpus_batched, 8 x 10 s clips, lane batch 2,
            against each clip's single-clip encode

Every time is printed with the card's name and power limit.  The last
line of stdout is one JSON object, {"ok": true, "device": {...}}; any
failed check raises, so the script then exits non-zero without it.
Without a GPU it exits non-zero at once and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
RATE = 44100
CLIP_S = 60.0

#: decoded SNR (dB, per channel, mp3tpu.decoder) of bench.make_signal
#: (60 s) encoded by this encoder on the CPU backend; the card must
#: reach each within SNR_MARGIN_DB
EXPECTED_SNR_L3 = (14.14, 11.15)
EXPECTED_SNR_L2 = (15.17, 11.65)
#: the Layer I/II margin of tests/test_layer12_fast.py
SNR_MARGIN_DB = 0.5
#: front end vs float64: an f32 dot of n terms of magnitude <= 1 errs
#: by ~sqrt(n) * 2^-24 (~1.4e-6 at the filterbank's n = 512), and three
#: such stages chain; a TF32 matmul (10-bit mantissa) errs by ~1e-3, so
#: this bound also shows that no front-end dot ran below full f32
XR_TOL = 1e-5
#: Layer I/II synthesis + analysis filterbank delay (samples)
L12_DELAY = {1: 545, 2: 481}

_compile = {"s": 0.0, "n": 0}


def say(msg):
    print(msg, flush=True)


def check(ok, what):
    """A smoke check; raises (unlike assert, also under python -O)."""
    if not ok:
        raise AssertionError(what)


def _on_duration(event, secs, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _compile["s"] += secs
        _compile["n"] += 1


def run_phase(name, fn, *args, **kwargs):
    """Run one phase; report its wall time and the XLA compile time
    spent in it.  Errors propagate."""
    say(f"== {name}")
    c0, n0 = _compile["s"], _compile["n"]
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say(f"   {name}: {time.perf_counter() - t0:.1f} s wall, "
        f"{_compile['s'] - c0:.1f} s XLA compile "
        f"({_compile['n'] - n0} programs)")
    return out


def card_info():
    """`name, power limit` lines of the cards, read by a child process
    that stays off JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def mode_of(flag):
    """The reference CLI's -m flag (tools/make_fixtures.py) as a mode."""
    from mp3tpu.tables import mpeg
    return {"s": mpeg.MODE_STEREO, "m": mpeg.MODE_MONO,
            "j": mpeg.MODE_JOINT}[flag]


def l3_cfg(mode="s", kbps=128, rate=RATE):
    from mp3tpu.config import EncoderConfig
    return EncoderConfig(layer=3, mode=mode_of(mode), bitrate_kbps=kbps,
                         sample_rate_hz=rate)


def check_l3_stream(out, n_samples, kbps, rate):
    """Every frame complete on the CBR grid plus one flush byte (as
    tests/test_fast_encoder.py checks)."""
    fsize = (144000 * kbps) // rate
    nframes = -(-n_samples // 1152)
    check(len(out) == nframes * fsize + 1, (len(out), nframes, fsize))
    check(out[0] == 0xFF and (out[1] & 0xF0) == 0xF0, "no frame sync")


def l3_snrs(out, pcm):
    from mp3tpu.decoder import decode_mp3
    from mp3tpu.decoder.layer3 import snr_db
    dec, _ = decode_mp3(out)
    return [float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
            for c in range(pcm.shape[1])]


def snr_at(orig, deco, lag):
    n = min(len(orig), len(deco) - lag)
    o = orig[:n].astype(np.float64)
    err = o - deco[lag:lag + n].astype(np.float64)
    return 10 * np.log10((o ** 2).sum() / max((err ** 2).sum(), 1e-30))


def mpg123_snrs(out, pcm):
    """Per-channel SNR under libmpg123, at the lag that maximises it on
    the first 2 s; None where the library is absent."""
    from mp3tpu.runtime import mpg123
    if not mpg123.available():
        return None
    dec, rate = mpg123.decode(out)
    check(rate == RATE and dec.shape[1] == pcm.shape[1], (rate, dec.shape))
    snrs = []
    for c in range(pcm.shape[1]):
        head = 2 * RATE
        lag = max(range(2000), key=lambda k: snr_at(
            pcm[:head, c], dec[:head + k, c], k))
        snrs.append(float(snr_at(pcm[:, c], dec[:, c], lag)))
    return snrs


def peak_bytes(device):
    """Peak bytes the device's arrays took; None where the backend
    keeps no statistics (the CPU)."""
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def check_snrs(label, got, expected, card):
    say(f"   {label}: SNR " + " / ".join(f"{s:.2f}" for s in got)
        + " dB (expected " + " / ".join(f"{e:.2f}" for e in expected)
        + f" - {SNR_MARGIN_DB}) [{card}]")
    for s, e in zip(got, expected):
        check(s >= e - SNR_MARGIN_DB, (label, got, expected))


# ---------------------------------------------------------------- phases

def phase_device(card):
    import jax

    import mp3tpu
    from mp3tpu.runtime.bitstream import get_lib
    d = jax.devices()
    say(f"   platform {d[0].platform}, kind {d[0].device_kind}, "
        f"count {len(d)}")
    say(f"   card: {card}")
    lib = get_lib()
    say(f"   native assembler: built ({lib._name})")
    mp3tpu.ensure_compile_cache()
    say(f"   compile cache: {jax.config.jax_compilation_cache_dir}")


def phase_oneshot(card, seconds=CLIP_S, expected_l3=EXPECTED_SNR_L3,
                  expected_l2=EXPECTED_SNR_L2):
    import jax

    import bench
    from mp3tpu.config import EncoderConfig
    from mp3tpu.decoder import layer12 as dec12
    from mp3tpu.encoder import encode_layer3_fast, encode_layer12_fast
    from mp3tpu.tables import mpeg

    pcm = bench.make_signal(seconds, RATE)
    cfg = l3_cfg()
    t0 = time.perf_counter()
    out = encode_layer3_fast(pcm, cfg)
    say(f"   layer3 cold (compile included): "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = encode_layer3_fast(pcm, cfg)
        times.append(time.perf_counter() - t0)
        check(again == out, "a steady run changed the bytes")
    steady = sorted(times)[1]
    say(f"   layer3 steady (median of 3): {steady:.3f} s = "
        f"{seconds / steady:.1f}x realtime [{card}]")
    check_l3_stream(out, len(pcm), 128, RATE)
    check_snrs("layer3 mp3tpu.decoder", l3_snrs(out, pcm), expected_l3,
               card)
    m = mpg123_snrs(out, pcm)
    if m is None:
        say("   layer3 libmpg123: not available")
    else:
        check_snrs("layer3 libmpg123", m, expected_l3, card)
    say(f"   peak_bytes_in_use: {peak_bytes(jax.devices()[0])} [{card}]")

    cfg2 = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                         sample_rate_hz=RATE)
    t0 = time.perf_counter()
    out2 = encode_layer12_fast(pcm, cfg2)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(encode_layer12_fast(pcm, cfg2) == out2,
          "a steady layer2 run changed the bytes")
    say(f"   layer2 192 kbps: cold {cold:.2f} s, steady "
        f"{time.perf_counter() - t0:.3f} s [{card}]")
    nframes = -(-len(pcm) // 1152)
    check(len(out2) == nframes * (144 * 192000 // RATE) + 1, len(out2))
    dec, _ = dec12.decode(out2)
    check_snrs("layer2 mp3tpu.decoder",
               [float(snr_at(pcm[:, c], dec[:, c] * 32768.0, L12_DELAY[2]))
                for c in range(2)], expected_l2, card)


def phase_stream(card, seconds=CLIP_S, window=2048, piece=RATE):
    import bench
    from mp3tpu.encoder import StreamEncoder, encode_layer3_fast

    pcm = bench.make_signal(seconds, RATE)
    one = encode_layer3_fast(pcm, l3_cfg(), chunk=window)
    enc = StreamEncoder(l3_cfg(), window=window)
    t0 = time.perf_counter()
    parts = [enc.feed(pcm[s:s + piece]) for s in range(0, len(pcm), piece)]
    streamed = b"".join(parts) + enc.finish()
    say(f"   stream window {window}: {time.perf_counter() - t0:.2f} s, "
        f"{len(streamed)} bytes [{card}]")
    check(streamed == one, "stream and one-shot differ")
    say("   stream == one-shot(chunk=%d): byte-identical" % window)


def phase_fixtures(card):
    from mp3tpu.config import EncoderConfig
    from mp3tpu.decoder import layer12 as dec12
    from mp3tpu.encoder import encode_layer3_fast, encode_layer12_fast
    from mp3tpu.runtime.wav import read_wav
    from tools.make_fixtures import (FIXTURES, LAYER12_FIXTURES,
                                     QUALITY_FIXTURES)

    with open(os.path.join(GOLDEN, "ref_snr.json")) as f:
        bars = json.load(f)
    rows = {r[0]: r for r in FIXTURES + QUALITY_FIXTURES}
    check(set(rows) == set(bars), set(rows) ^ set(bars))
    for name in sorted(bars):
        _, _, _, rate, nch, kbps, mode = rows[name][:7]
        pcm, got_rate = read_wav(os.path.join(GOLDEN, f"{name}.wav"))
        check(got_rate == rate, (name, got_rate))
        out = encode_layer3_fast(pcm[:, 0] if nch == 1 else pcm,
                                 l3_cfg(mode, kbps, rate))
        check_l3_stream(out, len(pcm), kbps, rate)
        snrs = l3_snrs(out, pcm)
        say(f"   {name:22s} " + " ".join(
            f"{s:6.2f}>={b}" for s, b in zip(snrs, bars[name])))
        check(all(s >= b for s, b in zip(snrs, bars[name])), name)

    for name, _, _, rate, nch, kbps, layer, mode, extra in LAYER12_FIXTURES:
        pcm, _ = read_wav(os.path.join(GOLDEN, f"{name}.wav"))
        cfg = EncoderConfig(layer=layer, mode=mode_of(mode),
                            bitrate_kbps=kbps, sample_rate_hz=rate,
                            error_protection="-e" in extra)
        fast = encode_layer12_fast(pcm, cfg)
        with open(os.path.join(GOLDEN, f"{name}.ref.mp{layer}"), "rb") as f:
            ref = f.read()
        check(len(fast) == len(ref) and fast[:3] == ref[:3], name)
        deco_f, _ = dec12.decode(fast)
        deco_r, _ = dec12.decode(ref)
        d = L12_DELAY[layer]
        s_f = [snr_at(pcm[:, c], deco_f[:, c] * 32768.0, d)
               for c in range(nch)]
        s_r = [snr_at(pcm[:, c], deco_r[:, c] * 32768.0, d)
               for c in range(nch)]
        say(f"   {name:22s} " + " ".join(
            f"{a:6.2f}>={b:.2f}-{SNR_MARGIN_DB}" for a, b in zip(s_f, s_r)))
        check(all(a >= b - SNR_MARGIN_DB for a, b in zip(s_f, s_r)), name)
    say(f"   fixtures: {len(bars)} Layer III, {len(LAYER12_FIXTURES)} "
        f"Layer I/II pass [{card}]")


def seeded_quantized(G, seed=0):
    """A quantized batch with the value mix the rate loop produces:
    silent, small, mid, ESC-range and out-of-range granules, trailing
    zero runs and count1 tails, long/short/start-stop blocks."""
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 1.5, 8.0, 40.0, 600.0, 9000.0], size=(G, 1))
    ix = np.abs(rng.randn(G, 576) * scale).astype(np.int32)
    cut = rng.randint(0, 577, size=G)
    tail = (rng.rand(G) * (cut + 1)).astype(np.int64)
    pos = np.arange(576)[None, :]
    ix = np.where(pos >= cut[:, None], 0, ix)
    ones = rng.randint(0, 2, size=(G, 576))
    ix = np.where((pos >= tail[:, None]) & (pos < cut[:, None]), ones, ix)
    is_short = rng.rand(G) < 0.3
    is_short_block = is_short | (rng.rand(G) < 0.1)
    return ix.astype(np.int32), is_short, is_short_block


def phase_integers(card, G=4096, dev=None, ref_dev=None, reps=20):
    """count_all on `dev` equals count_all on `ref_dev` (the CPU), with
    tolerance 0; returns the time of one evaluation on `dev` (ms)."""
    import jax

    from mp3tpu.ops import jaxloop
    from mp3tpu.tables import mpeg

    dev = dev or jax.devices()[0]
    ref_dev = ref_dev or jax.devices("cpu")[0]
    ST = jaxloop._static(mpeg.MPEG1, 0)
    fn = jax.jit(lambda ix, s, sb: jaxloop.count_all(ix, s, sb, ST))
    host = seeded_quantized(G)
    args = [jax.device_put(a, dev) for a in host]
    got = jax.device_get(fn(*args))
    ref = jax.device_get(fn(*[jax.device_put(a, ref_dev) for a in host]))
    check(sorted(got) == sorted(ref), (sorted(got), sorted(ref)))
    for k in sorted(ref):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args)
    jax.block_until_ready(r)
    ms = (time.perf_counter() - t0) / reps * 1e3
    say(f"   count_all G={G}: {dev.platform} == {ref_dev.platform} on "
        f"{len(ref)} outputs; {ms:.3f} ms per evaluation [{card}]")
    return ms


def phase_frontend(card, G=2048, dev=None, seed=1):
    """analyze_granules' xr on `dev` against numpy_ref.dsp in float64
    over G granules of a seeded signal with attacks (short blocks);
    returns the max abs error (full scale = 1)."""
    import jax

    from mp3tpu.models import layer3
    from mp3tpu.numpy_ref import dsp
    from mp3tpu.tables import mpeg

    dev = dev or jax.devices()[0]
    rng = np.random.RandomState(seed)
    t = np.arange(G * 576) / RATE
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.randn(len(t))
    for start in range(0, len(t) - 4000, 44100 // 3):
        x[start:start + 2000] += 0.5 * rng.randn(2000)
    pcm = np.clip(x * 20000, -32768, 32767).astype(np.int16)
    blocks = jax.device_put(pcm.reshape(G, 576).astype(np.float32), dev)
    halo = jax.device_put(np.zeros((2, 576), np.float32), dev)
    out = jax.device_get(layer3.analyze_granules(
        blocks, halo, mpeg.MPEG1, 0, float(RATE)))
    bt = np.asarray(out["block_type"])
    sb = dsp.granule_subbands(pcm.astype(np.float64) / 32768.0, G)
    xr_ref = dsp.mdct_granules(sb, bt)
    err = float(np.max(np.abs(np.asarray(out["xr"], np.float64) - xr_ref)))
    say(f"   analyze_granules G={G} ({int((bt == 2).sum())} short): max "
        f"|xr - float64 ref| = {err:.3g} <= {XR_TOL} [{card}]")
    check(err <= XR_TOL, err)
    return err


def phase_corpus(card, n=8, seconds=10.0, batch=2):
    from bench_corpus import make_clip
    from mp3tpu.decoder import decode_mp3
    from mp3tpu.decoder.layer3 import snr_db
    from mp3tpu.encoder import encode_layer3_fast
    from mp3tpu.parallel.corpus import encode_corpus_batched
    from mp3tpu.tables import mpeg

    clips = [(make_clip(s, seconds, RATE), RATE) for s in range(n)]
    kw = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)
    outs, stats = encode_corpus_batched(clips, kw, batch=batch)
    say(f"   corpus cold: {stats['wall_s']:.2f} s [{card}]")
    outs2, stats = encode_corpus_batched(clips, kw, batch=batch)
    say(f"   corpus steady: {stats['wall_s']:.3f} s = "
        f"{stats['x_realtime']:.1f}x realtime [{card}]")
    check(outs2 == outs, "a steady corpus run changed the bytes")
    for i, ((pcm, _), out) in enumerate(zip(clips, outs)):
        single = encode_layer3_fast(pcm, l3_cfg())
        check(len(out) == len(single), (i, len(out), len(single)))
        dec_b, _ = decode_mp3(out)
        dec_s, _ = decode_mp3(single)
        for ch in range(2):
            ref = pcm[ch].astype(np.float64)
            s_b = float(snr_db(ref, dec_b[:, ch]))
            s_s = float(snr_db(ref, dec_s[:, ch]))
            check(abs(s_b - s_s) < SNR_MARGIN_DB, (i, ch, s_b, s_s))
        say(f"   clip {i}: corpus {s_b:.2f} dB vs single {s_s:.2f} dB "
            f"(channel 1)")


def phase_mesh(card, n=4, seconds=CLIP_S, expected=EXPECTED_SNR_L3):
    """encode_layer3_sharded over an n-GPU mesh against the one-GPU
    encode_layer3_fast on the same clip."""
    import jax

    import bench
    from mp3tpu.encoder import encode_layer3_fast
    from mp3tpu.parallel import clip, sharding

    devices = jax.devices()[:n]
    check(len(devices) == n, (len(devices), n))
    mesh = sharding.make_mesh(devices=devices)
    pcm = bench.make_signal(seconds, RATE)
    outs = []
    for label, enc in (
            ("one GPU", lambda: encode_layer3_fast(pcm, l3_cfg())),
            (f"{n}-GPU mesh", lambda: clip.encode_layer3_sharded(
                pcm, l3_cfg(), mesh=mesh))):
        t0 = time.perf_counter()
        out = enc()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(enc() == out, label)
        say(f"   {label}: cold {cold:.2f} s, steady "
            f"{time.perf_counter() - t0:.3f} s [{card}]")
        check_l3_stream(out, len(pcm), 128, RATE)
        check_snrs(label, l3_snrs(out, pcm), expected, card)
        outs.append(out)
    check(len(outs[0]) == len(outs[1]), [len(o) for o in outs])
    say(f"   frames: {-(-len(pcm) // 1152)} on both paths")
    peaks = [peak_bytes(d) for d in devices]
    say(f"   peak_bytes_in_use per device: {peaks}")
    check(all(p is None or p > 0 for p in peaks),
          "a device of the mesh did no work")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    cards = card_info()
    for ln in cards:
        say(ln)
    card = f"{cards[0]} x{args.chips}" if args.chips > 1 else cards[0]
    import jax.monitoring
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    run_phase("device", phase_device, card)
    if args.chips > 1:
        run_phase("mesh", phase_mesh, card, n=args.chips)
    else:
        for name, phase in (("oneshot", phase_oneshot),
                            ("stream", phase_stream),
                            ("fixtures", phase_fixtures),
                            ("integers", phase_integers),
                            ("frontend", phase_frontend),
                            ("corpus", phase_corpus)):
            run_phase(name, phase, card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
