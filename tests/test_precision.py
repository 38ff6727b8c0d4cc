"""No float matmul in the device programs runs below full precision.

A GPU runs DEFAULT-precision f32 dots in TF32 (10-bit mantissa).  The
encoder's dots feed integer decisions (stepsizes, scalefactors, table
choices, bit counts), so every one must lower at HIGHEST.  The programs
are lowered here with x64 off, as the production path runs them.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mp3tpu.config import EncoderConfig
from mp3tpu.models import layer3
from mp3tpu.ops import jaxbits, jaxlayer12
from mp3tpu.tables import layer12 as T12
from mp3tpu.tables import mpeg

_DOT = re.compile(r"stablehlo\.dot_general .*->\s*tensor<(?:[0-9x]*x)?(\w+)>")
_PRECISION = re.compile(r"precision = \[(\w+), (\w+)\]")


def _lower_layer3(mode, kbps, rate, n_pad=16):
    cfg = EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    cfg.finalize()
    nch, mode_gr = cfg.nchannels, cfg.mode_gr
    bits_per_frame = 8 * cfg.slots_per_frame()[0]
    sideinfo = mpeg.sideinfo_bits(cfg.version, nch, cfg.error_protection)
    mean_bits = (bits_per_frame - sideinfo) // mode_gr
    resv_max = min(max(0, 7680 - bits_per_frame),
                   4088 if mode_gr == 2 else 2040)
    cap = jaxbits.payload_cap_words(n_pad // mode_gr, bits_per_frame,
                                    sideinfo, resv_max, nch * n_pad)
    return layer3.encode_segment_fused.lower(
        jnp.zeros((nch, 4 + n_pad, 576), jnp.int16),
        jnp.zeros(nch, jnp.int32), jnp.int32(0), cfg.version,
        cfg.sampling_frequency, float(rate), 96, nch, cap, n_pad,
        mean_bits, resv_max, mode_gr, 28)


def _lower_layer2(nframes=4):
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=44100)
    cfg.finalize()
    table, sblimit = T12.pick_table(cfg.version, 2, cfg.bitrate_index,
                                    cfg.sampling_frequency, 2, 192, 44.1)
    pcm = jnp.zeros((2, nframes * 1152), jnp.float32)
    return jaxlayer12.analyze_frames.lower(pcm, pcm, 2, table, sblimit, 2,
                                           nframes, 44100.0)


CASES = {
    "layer3_stereo_44k": lambda: _lower_layer3(mpeg.MODE_STEREO, 128,
                                               44100),
    "layer3_mono_lsf_22k": lambda: _lower_layer3(mpeg.MODE_MONO, 32,
                                                 22050),
    "layer2_stereo_192": _lower_layer2,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_float_dot_below_highest(case):
    with jax.enable_x64(False):
        text = CASES[case]().as_text()
    float_dots, low = 0, []
    for line in text.splitlines():
        m = _DOT.search(line)
        if not m or not m.group(1).startswith(("f", "bf")):
            continue
        float_dots += 1
        p = _PRECISION.search(line)
        if p is None or p.groups() != ("HIGHEST", "HIGHEST"):
            low.append(line.strip()[:160])
    assert float_dots > 0, "no float dot found: the parser is stale"
    assert not low, f"{len(low)} float dots below HIGHEST:\n" + "\n".join(
        low[:5])


def test_exact_matmuls_scope_is_per_call():
    """The precision scope is re-entered per call, so nested and
    repeated traces all see HIGHEST."""
    from mp3tpu.ops import exact_matmuls

    @exact_matmuls
    def f(a):
        return a @ a

    x = np.eye(3, dtype=np.float32)
    with jax.enable_x64(False):
        for _ in range(2):
            text = jax.jit(f).lower(x).as_text()
            assert "precision = [HIGHEST, HIGHEST]" in text
