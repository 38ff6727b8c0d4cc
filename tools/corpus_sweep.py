#!/usr/bin/env python3
"""Corpus lane-width sweep on one device.

Clip groups are embarrassingly parallel (zero cross-clip traffic), so
the lanes -> throughput curve on one device is also the per-host curve
of a multi-host corpus run.

Sweeps the lane batch at fixed lookahead on a 32-clip x 10 s corpus
and records aggregate x-realtime per width, plus the single-clip
headline for comparison.  Usage: python tools/corpus_sweep.py [out]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("MP3TPU_CORPUS_LOOKAHEAD", "3")


def main():
    import jax

    from bench import make_signal
    from bench_corpus import make_clip
    from mp3tpu.config import EncoderConfig
    from mp3tpu.encoder import encode_layer3_fast
    from mp3tpu.parallel.corpus import encode_corpus_batched
    from mp3tpu.tables import mpeg

    n_clips, seconds, rate = 32, 10.0, 44100
    clips = [(make_clip(s, seconds, rate), rate) for s in range(n_clips)]
    kw = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)

    # single-clip headline for the comparison row (median of 3)
    pcm60 = make_signal(60.0, rate)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=rate)
    encode_layer3_fast(pcm60, cfg)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_layer3_fast(pcm60, cfg)
        ts.append(time.perf_counter() - t0)
    single = 60.0 / sorted(ts)[1]

    sweep = []
    for batch in (1, 2, 4, 8, 16):
        outs, _ = encode_corpus_batched(clips[:2 * batch], kw,
                                        batch=batch)   # warm compile
        assert all(len(o) > 1000 for o in outs)
        runs = []
        for _ in range(3):   # median of 3
            outs, stats = encode_corpus_batched(clips, kw, batch=batch)
            assert all(len(o) > 1000 for o in outs)
            runs.append(stats)
        runs.sort(key=lambda s: s["x_realtime"])
        stats = runs[1]
        sweep.append({"lane_batch": batch,
                      "aggregate_x_realtime": round(stats["x_realtime"], 1),
                      "spread_x": [round(runs[0]["x_realtime"], 1),
                                   round(runs[-1]["x_realtime"], 1)],
                      "wall_s": round(stats["wall_s"], 2)})
        print(f"batch {batch}: {stats['x_realtime']:.1f}x "
              f"[{runs[0]['x_realtime']:.0f},{runs[-1]['x_realtime']:.0f}]",
              file=sys.stderr)

    best = max(sweep, key=lambda r: r["aggregate_x_realtime"])
    dev = jax.devices()
    report = {
        "corpus": f"{n_clips} clips x {seconds:.0f}s stereo 44.1kHz "
                  "128kbps, 1 device",
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "lookahead_groups": int(os.environ["MP3TPU_CORPUS_LOOKAHEAD"]),
        "sweep": sweep,
        "best": best,
        "single_clip_60s_x_realtime": round(single, 1),
        "aggregate_vs_single_clip": round(
            best["aggregate_x_realtime"] / single, 2),
    }
    out_path = sys.argv[1] if len(sys.argv) > 1 else "corpus_sweep.json"
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"best_batch": best["lane_batch"],
                      "aggregate_x": best["aggregate_x_realtime"],
                      "vs_single": report["aggregate_vs_single_clip"]}))


if __name__ == "__main__":
    main()
