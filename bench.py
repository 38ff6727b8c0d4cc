#!/usr/bin/env python3
"""Headline benchmark: Layer III encode real-time factor on one chip.

Encodes a synthetic 60 s stereo clip at 128 kbps (the reference's
headline configuration, BASELINE.md) end-to-end -- device psy/DSP/rate
loop + host reservoir scan + native bitstream assembly -- and reports
audio-seconds per wall-second.

Baseline: the reference C encoder measures 33.1x real-time on one CPU
core for this configuration (BASELINE.md).

Prints one JSON line naming the device it ran on:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N}
"""
import json
import sys
import time

import numpy as np

BASELINE_RT = 33.1


def make_signal(seconds, rate):
    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.RandomState(42)
    x = (0.35 * np.sin(2 * np.pi * 440.0 * t)
         + 0.15 * np.sin(2 * np.pi * 1871.0 * t)
         + 0.08 * rng.randn(len(t)))
    y = (0.3 * np.sin(2 * np.pi * 554.0 * t + 0.3)
         + 0.1 * rng.randn(len(t)))
    pcm = np.stack([x, y], axis=1)
    return np.clip(pcm * 24000, -32768, 32767).astype(np.int16)


def main():
    import jax

    from mp3tpu.config import EncoderConfig
    from mp3tpu.encoder import encode_layer3_fast
    from mp3tpu.tables import mpeg

    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    rate = 44100
    pcm = make_signal(seconds, rate)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=rate)

    # warmup: compile every shape this clip will use
    out = encode_layer3_fast(pcm, cfg)
    assert len(out) > 1000

    # median of 5 steady-state runs; min/max report the spread
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = encode_layer3_fast(pcm, cfg)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]

    rt = seconds / dt
    dev = jax.devices()
    print(json.dumps({
        "metric": "layer3 encode realtime factor (stereo 44.1kHz 128kbps, 1 chip)",
        "value": round(rt, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rt / BASELINE_RT, 3),
        "spread_x": [round(seconds / times[-1], 1),
                     round(seconds / times[0], 1)],
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
    }))


if __name__ == "__main__":
    main()
