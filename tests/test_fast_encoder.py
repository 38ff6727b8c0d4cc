"""Production (device) encoder path: validity + decoded-SNR quality gate.

BASELINE.md requires decoded SNR >= the reference encoder at every
bitrate; reference numbers live in tests/golden/ref_snr.json.
"""
import json
import os

import numpy as np
import pytest

from mp3tpu.config import EncoderConfig
from mp3tpu.decoder import decode_mp3
from mp3tpu.decoder.layer3 import snr_db
from mp3tpu.encoder import encode_layer3_fast
from mp3tpu.runtime.wav import read_wav
from mp3tpu.tables import mpeg

CASES = [
    ("sine_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("noise_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("sweep_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("noise_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("trans_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("sine_st_128_32k", mpeg.MODE_STEREO, 128, 32000),
    # moderate-level fixtures: the reference quantizer does not clip
    # whole granules here, so the baselines are honest quality bars
    # (e.g. q_trans 24-25 dB, q_mix 20-45 dB) rather than saturation
    # artifacts; q_sine's low bar (6.6-7.9 dB) is the reference's
    # pow_nint ix=2047 saturation on dominant tonal lines, which the
    # fast path fixes (see ops/jaxloop.py).
    ("q_sine_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("q_sine_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_noise_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_sweep_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_trans_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_mix_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_mix_st_192", mpeg.MODE_STEREO, 192, 44100),
    ("q_mix_mono_96_32k", mpeg.MODE_MONO, 96, 32000),
    ("q_mix_st_320_48k", mpeg.MODE_STEREO, 320, 48000),
]

FAST = {"sine_mono_64", "noise_mono_64", "q_sine_mono_64"}

# slow marks must be applied at COLLECTION time for -m "not slow" to
# deselect (request.applymarker after collection does not)
_PARAMS = [pytest.param(*c, id=c[0],
                        marks=() if c[0] in FAST else (pytest.mark.slow,))
           for c in CASES]


@pytest.mark.parametrize("name,mode,kbps,rate", _PARAMS)
def test_fast_mode_beats_reference_snr(golden_dir, name, mode, kbps, rate):
    with open(os.path.join(golden_dir, "ref_snr.json")) as f:
        ref = json.load(f)
    pcm, r = read_wav(os.path.join(golden_dir, f"{name}.wav"))
    cfg = EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    data = pcm[:, 0] if mode == mpeg.MODE_MONO else pcm
    out = encode_layer3_fast(data, cfg)
    # structural validity: all frames complete on the CBR grid (the
    # slot_lag padder never pads, BASELINE.md) + one trailing flush
    # byte (close_bit_stream_w semantics)
    fsize = (144000 * kbps) // rate
    nframes = -(-pcm.shape[0] // 1152)
    assert len(out) == nframes * fsize + 1, (len(out), nframes, fsize)
    assert out[0] == 0xFF and (out[1] & 0xF0) == 0xF0
    dec, drate = decode_mp3(out)
    assert drate == rate
    for c in range(min(dec.shape[1], pcm.shape[1])):
        snr = float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
        assert snr >= ref[name][c], (name, c, snr, ref[name][c])
