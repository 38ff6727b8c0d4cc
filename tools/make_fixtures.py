#!/usr/bin/env python3
"""Generate golden fixtures: deterministic WAVs + reference-encoder MP3s.

Requires the reference binary at /tmp/ref/mp3enc (built by
`gcc -O2 -std=gnu89 -DUNIX -DBS_FORMAT=BINARY src/*.c -o mp3enc -lm`
from /root/reference).  Fixture WAVs are committed; the reference MP3s
are committed as golden outputs in tests/golden/.
"""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from mp3tpu.runtime.wav import write_wav  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")
REF = "/tmp/ref/mp3enc"


def gen_signal(kind, seconds, rate, nch, seed=0, level=1.0):
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    if kind == "mix":
        # music-like: harmonic stack + slow AM + soft noise floor
        x = np.zeros(n)
        for k, f0 in enumerate((220.0, 440.0, 659.3, 880.0, 1318.5)):
            x += (0.5 / (k + 1)) * np.sin(2 * np.pi * f0 * t + 0.7 * k)
        x *= 0.5 * (1.0 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
        x += 0.01 * rng.randn(n)
        if nch == 2:
            y = np.zeros(n)
            for k, f0 in enumerate((246.9, 493.9, 740.0, 987.8)):
                y += (0.5 / (k + 1)) * np.sin(2 * np.pi * f0 * t + 0.3 * k)
            y += 0.01 * rng.randn(n)
            x = np.stack([x, y], axis=1)
    elif kind == "sine":
        x = 0.6 * np.sin(2 * np.pi * 440.0 * t)
        if nch == 2:
            y = 0.6 * np.sin(2 * np.pi * 554.37 * t)
            x = np.stack([x, y], axis=1)
    elif kind == "sweep":
        f = 40.0 * (rate / 2 / 2 / 40.0) ** (t / t[-1])
        phase = np.cumsum(2 * np.pi * f / rate)
        x = 0.5 * np.sin(phase)
        if nch == 2:
            x = np.stack([x, x[::-1]], axis=1)
    elif kind == "noise":
        x = 0.3 * rng.randn(n)
        if nch == 2:
            x = np.stack([x, 0.3 * rng.randn(n)], axis=1)
    elif kind == "transient":
        # tone with periodic attacks to exercise short blocks
        x = 0.1 * np.sin(2 * np.pi * 330.0 * t)
        for k in range(int(seconds * 4)):
            i = int(k * rate / 4)
            j = min(n, i + rate // 40)
            x[i:j] += 0.8 * np.sin(2 * np.pi * 3000.0 * t[i:j]) * np.exp(
                -40.0 * (t[i:j] - t[i]))
        if nch == 2:
            x = np.stack([x, np.roll(x, 173)], axis=1)
    elif kind == "silence_mix":
        x = np.zeros(n)
        x[n // 4:n // 2] = 0.5 * np.sin(2 * np.pi * 1000.0 * t[n // 4:n // 2])
        if nch == 2:
            x = np.stack([x, x], axis=1)
    else:
        raise ValueError(kind)
    if x.ndim == 1:
        x = x[:, None] if nch == 1 else np.stack([x, x], axis=1)
    return np.clip(x * level * 32767, -32768, 32767).astype(np.int16)


FIXTURES = [
    # (name, kind, seconds, rate, nch, bitrate, mode_flag)
    ("sine_mono_64", "sine", 1.2, 44100, 1, 64, "m"),
    ("sine_st_128", "sine", 1.2, 44100, 2, 128, "s"),
    ("sweep_st_128", "sweep", 2.0, 44100, 2, 128, "s"),
    ("noise_st_128", "noise", 1.0, 44100, 2, 128, "s"),
    ("trans_st_128", "transient", 2.0, 44100, 2, 128, "s"),
    ("silence_st_128", "silence_mix", 1.0, 44100, 2, 128, "s"),
    ("sweep_st_320_48k", "sweep", 1.0, 48000, 2, 320, "s"),
    ("sine_st_128_32k", "sine", 1.0, 32000, 2, 128, "s"),
    ("noise_mono_64", "noise", 1.0, 44100, 1, 64, "m"),
    ("trans_st_256", "transient", 1.5, 44100, 2, 256, "s"),
]

# Quality fixtures at moderate level (-16..-20 dBFS): the reference's
# pow_nint quantizer does NOT saturate here, so its decoded SNR is the
# real 25-60 dB -- these make the >=-reference quality gate meaningful
# (with saturated fixtures alone the gate measured clipping, not quality).
QUALITY_FIXTURES = [
    ("q_sine_st_128", "sine", 1.2, 44100, 2, 128, "s", 0.15),
    ("q_sweep_st_128", "sweep", 1.5, 44100, 2, 128, "s", 0.15),
    ("q_noise_st_128", "noise", 1.0, 44100, 2, 128, "s", 0.15),
    ("q_trans_st_128", "transient", 1.5, 44100, 2, 128, "s", 0.15),
    ("q_mix_st_128", "mix", 1.5, 44100, 2, 128, "s", 0.25),
    ("q_mix_st_192", "mix", 1.5, 44100, 2, 192, "s", 0.25),
    ("q_sine_mono_64", "sine", 1.0, 44100, 1, 64, "m", 0.15),
    ("q_mix_st_320_48k", "mix", 1.0, 48000, 2, 320, "s", 0.25),
    ("q_mix_mono_96_32k", "mix", 1.0, 32000, 1, 96, "m", 0.25),
]


# Layer I/II fixtures: (name, kind, secs, rate, nch, bitrate, layer,
# mode_flag, extra_flags)
LAYER12_FIXTURES = [
    ("l2_sine_st_192", "sine", 0.8, 44100, 2, 192, 2, "s", []),
    ("l2_noise_j_128", "noise", 0.8, 44100, 2, 128, 2, "j", []),
    ("l2_sweep_mono_96", "sweep", 0.8, 44100, 1, 96, 2, "m", []),
    ("l2_trans_st_256_48k", "transient", 0.8, 48000, 2, 256, 2, "s", []),
    ("l2_sine_st_128_32k", "sine", 0.8, 32000, 2, 128, 2, "s", []),
    ("l2_noise_st_192_crc", "noise", 0.6, 44100, 2, 192, 2, "s", ["-e"]),
    ("l1_sine_st_384", "sine", 0.6, 44100, 2, 384, 1, "s", []),
    ("l1_noise_mono_192", "noise", 0.6, 44100, 1, 192, 1, "m", []),
    ("l1_sweep_j_256", "sweep", 0.6, 44100, 2, 256, 1, "j", []),
    ("l1_noise_st_448_48k_crc", "noise", 0.6, 48000, 2, 448, 1, "s", ["-e"]),
]


def main(rows=None):
    os.makedirs(GOLDEN, exist_ok=True)
    if rows is None:
        rows = [f + (1.0,) for f in FIXTURES] + QUALITY_FIXTURES
    for name, kind, secs, rate, nch, kbps, mode, level in rows:
        wav = os.path.join(GOLDEN, f"{name}.wav")
        mp3 = os.path.join(GOLDEN, f"{name}.ref.mp3")
        pcm = gen_signal(kind, secs, rate, nch, level=level)
        write_wav(wav, pcm, rate)
        cmd = [REF, "-l", "3", "-m", mode, "-p", "2", "-s", str(rate / 1000.0),
               "-b", str(kbps), wav, mp3]
        r = subprocess.run(cmd, capture_output=True, text=True)
        assert os.path.exists(mp3) and os.path.getsize(mp3) > 0, (name, r.stderr, r.stdout)
        print(name, os.path.getsize(mp3), "bytes")
    main_layer12()


def main_layer12():
    for (name, kind, secs, rate, nch, kbps, layer, mode,
         extra) in LAYER12_FIXTURES:
        wav = os.path.join(GOLDEN, f"{name}.wav")
        out = os.path.join(GOLDEN, f"{name}.ref.mp{layer}")
        pcm = gen_signal(kind, secs, rate, nch, seed=1)
        write_wav(wav, pcm, rate)
        cmd = [REF, "-l", str(layer), "-m", mode, "-p", "2",
               "-s", str(rate / 1000.0), "-b", str(kbps)] + extra + [wav, out]
        r = subprocess.run(cmd, capture_output=True, text=True)
        assert os.path.exists(out) and os.path.getsize(out) > 0, (name, r.stderr)
        print(name, os.path.getsize(out), "bytes")


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == "layer12":
        main_layer12()
    elif len(sys.argv) > 1 and sys.argv[1] == "quality":
        main(rows=QUALITY_FIXTURES)
    else:
        main()
