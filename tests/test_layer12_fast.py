"""Layer I/II device fast-path tests: decoded quality must match the
byte-exact oracle / reference stream, and structure must be valid.

The fast path uses f32 DSP + jnp.fft (vs the oracle's exact float32
split-radix + f64 filterbank), so streams are not byte-identical;
decoded SNR must agree within a tight margin.
"""
import os

import numpy as np
import pytest

from mp3tpu.config import EncoderConfig
from mp3tpu.decoder import layer12 as dec12
from mp3tpu.encoder import encode_layer12_fast
from mp3tpu.runtime.wav import read_wav
from mp3tpu.tables import mpeg

CASES = [
    ("l2_sine_st_192", 2, mpeg.MODE_STEREO, 192, 44100),
    ("l2_noise_j_128", 2, mpeg.MODE_JOINT, 128, 44100),
    ("l2_sweep_mono_96", 2, mpeg.MODE_MONO, 96, 44100),
    ("l2_trans_st_256_48k", 2, mpeg.MODE_STEREO, 256, 48000),
    ("l1_sine_st_384", 1, mpeg.MODE_STEREO, 384, 44100),
    ("l1_sweep_j_256", 1, mpeg.MODE_JOINT, 256, 44100),
]

_DELAY = {1: 545, 2: 481}  # synthesis+analysis filterbank delay


def _snr(orig, deco, d):
    n = min(len(orig) - d, len(deco) - d)
    o = orig[:n].astype(np.float64)
    err = o - deco[d:d + n]
    return 10 * np.log10((o ** 2).sum() / max((err ** 2).sum(), 1e-30))


@pytest.mark.parametrize("name,layer,mode,kbps,rate", CASES)
def test_fast_matches_reference_quality(golden_dir, name, layer, mode,
                                        kbps, rate):
    pcm, got_rate = read_wav(os.path.join(golden_dir, f"{name}.wav"))
    assert got_rate == rate
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    fast = encode_layer12_fast(pcm, cfg)
    ref = open(os.path.join(golden_dir, f"{name}.ref.mp{layer}"),
               "rb").read()
    # CBR structure: same stream length as the reference
    assert len(fast) == len(ref)
    # same frame headers (sync + config fields; mode/mode_ext may vary
    # per frame in joint mode, compare the fixed first 3 bytes)
    assert fast[:3] == ref[:3]

    deco_f, _ = dec12.decode(fast)
    deco_r, _ = dec12.decode(ref)
    d = _DELAY[layer]
    for ch in range(pcm.shape[1]):
        s_f = _snr(pcm[:, ch], deco_f[:, ch] * 32768.0, d)
        s_r = _snr(pcm[:, ch], deco_r[:, ch] * 32768.0, d)
        assert s_f >= s_r - 0.5, (name, ch, s_f, s_r)


def test_fast_crc_stream_decodes(golden_dir):
    pcm, rate = read_wav(os.path.join(golden_dir,
                                      "l2_noise_st_192_crc.wav"))
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=rate, error_protection=True)
    fast = encode_layer12_fast(pcm, cfg)
    deco, _ = dec12.decode(fast)
    assert len(deco) >= len(pcm) - 1152
    s = _snr(pcm[:, 0], deco[:, 0] * 32768.0, _DELAY[2])
    assert s > 0.0
