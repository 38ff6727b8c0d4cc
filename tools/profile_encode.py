#!/usr/bin/env python3
"""Produce a per-stage profile record for the headline encode.

Runs the 60 s stereo 128 kbps configuration twice (warmup compiles,
then a measured pass with the stage profiler) and writes a JSON record
with the stage breakdown and the XLA cost-analysis FLOPs of the device
programs.

Usage: python tools/profile_encode.py [seconds] [out.json]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _program_flops(seconds):
    """XLA cost-analysis FLOPs of the two big programs at the bench
    shapes, summed over the segment plan.  XLA reports static flops per
    execution and counts each while-loop body once, so this
    UNDERCOUNTS the search loops: a lower bound on the work."""
    import jax
    import jax.numpy as jnp

    from mp3tpu.encoder import SUPER_BUCKETS, _plan_segments
    from mp3tpu.models import layer3
    from mp3tpu.tables import mpeg

    rate = 44100
    nframes = -(-int(seconds * rate) // 1152)
    G = nframes * 2
    plan = _plan_segments(G, SUPER_BUCKETS)
    total = 0.0
    for _, _, n_pad in plan:
        bl = jnp.zeros((2, 4 + n_pad, 576), jnp.int16)
        fsm = jnp.zeros(2, jnp.int32)
        lowered = layer3.analyze_demand_fused.lower(
            bl, fsm, mpeg.MPEG1, 0, 44100.0)
        c = lowered.compile().cost_analysis()
        total += float(c.get("flops", 0.0))
        N = 2 * n_pad
        lowered = layer3.encode_final.lower(
            jnp.zeros((N, 576), jnp.float32),
            jnp.zeros((N, 21), jnp.float32),
            jnp.zeros((N, 12, 3), jnp.float32),
            jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.float32),
            mpeg.MPEG1, 0, payload_words=96,
            scfsi=jnp.zeros((2, n_pad // 2, 4), jnp.int32),
            sf_fix=jnp.zeros((2, n_pad // 2, 21), jnp.int8), nch=2)
        c = lowered.compile().cost_analysis()
        total += float(c.get("flops", 0.0))
    return total


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    out_path = sys.argv[2] if len(sys.argv) > 2 else "profile.json"

    import bench
    from mp3tpu.config import EncoderConfig
    from mp3tpu.encoder import encode_layer3_fast
    from mp3tpu.runtime.profiling import Profiler
    from mp3tpu.tables import mpeg

    pcm = bench.make_signal(seconds, 44100)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100)
    t0 = time.perf_counter()
    encode_layer3_fast(pcm, cfg)             # warmup / compile
    warm = time.perf_counter() - t0

    prof = Profiler()
    t0 = time.perf_counter()
    out = encode_layer3_fast(pcm, cfg, prof=prof)
    wall = time.perf_counter() - t0

    import jax
    try:
        flops = _program_flops(seconds)
    except Exception:
        flops = None
    dev = jax.devices()
    record = {
        "config": "layer3 stereo 44.1kHz 128kbps",
        "clip_seconds": seconds,
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
        "warmup_s": round(warm, 3),
        "wall_s": round(wall, 4),
        "x_realtime": round(seconds / wall, 2),
        "bytes": len(out),
        "stages_s": {k: round(v, 4) for k, v in prof.stages.items()},
        "xla_cost_flops": flops,
        "flops_note": "XLA cost-analysis flops of the two device "
                      "programs; while-loop bodies are counted once, so "
                      "this lower-bounds the search work",
    }
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
