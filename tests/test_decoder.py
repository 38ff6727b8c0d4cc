"""Decoder validation: perfect-reconstruction loopback and decodability
of encoder output.

Note on quality baselines (tests/golden/ref_snr.json): the reference
encoder's fast-pow quantizer saturates at ix=2047 (pow_nint gallop
bound, pow_nint.h:15-49), which defeats the ix_max<=8205 range check
(loop.c:588) and clips every loud spectral peak; the outer loop's
scalefactor amplification then amplifies the saturation.  Decoded SNR
of the reference on the loud golden fixtures is therefore only ~0-3 dB.
The production encoder corrects the quantizer and must beat these
numbers (BASELINE.md: decoded SNR >= reference at every bitrate).
"""
import numpy as np
import pytest

import mp3tpu.decoder.layer3 as D
from mp3tpu.config import EncoderConfig
from mp3tpu.decoder import decode_mp3
from mp3tpu.decoder.layer3 import snr_db
from mp3tpu.numpy_ref import dsp, encode_layer3
from mp3tpu.tables import mpeg


def test_filterbank_mdct_loopback():
    """analysis -> synthesis without quantization reaches the polyphase
    filterbank's intrinsic ~90 dB aliasing floor at delay 1057."""
    rate = 44100
    t = np.arange(int(0.3 * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * 441.37 * t) + 0.1 * np.sin(2 * np.pi * 3333.0 * t)
    G = 20
    xs = np.zeros(G * 576)
    xs[:G * 576] = x[:G * 576]
    sb = dsp.granule_subbands(xs, G)
    xr = dsp.mdct_granules(sb, np.zeros(G, np.int32))
    overlap = np.zeros((32, 18))
    synth = D._Synth()
    outs = []
    for g in range(G):
        xrb = xr[g].reshape(32, 18).copy()
        for sbn in range(31):
            for k in range(8):
                lo = xrb[sbn, 17 - k]
                hi = xrb[sbn + 1, k]
                xrb[sbn, 17 - k] = lo * D._cs[k] - hi * D._ca[k]
                xrb[sbn + 1, k] = hi * D._cs[k] + lo * D._ca[k]
        sb_s = np.zeros((18, 32))
        for sbn in range(32):
            x36 = D._imdct_long(xrb[sbn], 0)
            sb_s[:, sbn] = x36[:18] + overlap[sbn]
            overlap[sbn] = x36[18:]
        sb_s[1::2, 1::2] *= -1.0
        for tt in range(18):
            outs.append(synth.run(sb_s[tt]))
    dec = np.concatenate(outs)
    n = len(xs) - 1057
    a = xs[:n]
    b = dec[1057:1057 + n]
    snr = 10 * np.log10(np.sum(a * a) / np.sum((a - b) ** 2))
    assert snr > 85.0, snr


@pytest.mark.slow
def test_decode_golden_mp3(golden_dir):
    import os
    with open(os.path.join(golden_dir, "sine_st_128.ref.mp3"), "rb") as f:
        data = f.read()
    pcm, rate = decode_mp3(data)
    assert rate == 44100 and pcm.shape[1] == 2
    assert np.max(np.abs(pcm)) > 0.01


@pytest.mark.slow
def test_oracle_output_decodes():
    rate = 44100
    t = np.arange(int(0.5 * rate)) / rate
    x = (0.05 * 32767 * np.sin(2 * np.pi * 441.0 * t)).astype(np.int16)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64,
                        sample_rate_hz=rate)
    out = encode_layer3(x, cfg)
    pcm, r = decode_mp3(out)
    assert r == rate
    # quality is limited by the reference's saturating quantizer, which
    # the oracle replicates; only check structural sanity here
    assert np.isfinite(snr_db(x.astype(np.float64), pcm[:, 0]))
