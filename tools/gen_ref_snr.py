#!/usr/bin/env python3
"""Regenerate tests/golden/ref_snr.json: decoded SNR of the REFERENCE
encoder's golden MP3s vs their source WAVs, per channel.

These are the quality baselines the fast path must meet or beat
(BASELINE.md north star: decoded SNR >= reference at every bitrate).
Includes the moderate-level q_* fixtures where the reference's
quantizer does not saturate (real 25-60 dB baselines).
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from mp3tpu.decoder import decode_mp3  # noqa: E402
from mp3tpu.decoder.layer3 import snr_db  # noqa: E402
from mp3tpu.runtime.wav import read_wav  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")


def main():
    out = {}
    for fn in sorted(os.listdir(GOLDEN)):
        if not fn.endswith(".ref.mp3"):
            continue
        name = fn[:-8]
        pcm, rate = read_wav(os.path.join(GOLDEN, f"{name}.wav"))
        with open(os.path.join(GOLDEN, fn), "rb") as f:
            dec, drate = decode_mp3(f.read())
        assert drate == rate, (name, drate, rate)
        snrs = []
        for c in range(pcm.shape[1]):
            snrs.append(round(float(snr_db(
                pcm[:, c].astype(np.float64), dec[:, min(c, dec.shape[1] - 1)])), 2))
        out[name] = snrs
        print(name, snrs)
    with open(os.path.join(GOLDEN, "ref_snr.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
