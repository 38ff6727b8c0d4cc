"""Command-line driver, mirroring the reference CLI
(musicin.c:157-296 parse_args, :834-857 usage):

  mp3tpu [-l lay][-m mode][-p psy][-s sfrq][-b br][-d emp]
         [-c][-o][-e][-L][--exact] inputPCM [outBS]

Input formats: WAV (header parsed properly -- unlike the reference's
fixed 0x2c skip, but -s still overrides), AIFF (rate/channels from the
header, like the reference), raw 16-bit PCM big-endian (default) or
little-endian (-L), and '-' for stdin (raw PCM stream).

--exact uses the byte-exact oracle encoders instead of the device fast
path (identical output to the reference binary where the reference is
functional).
"""
import argparse
import os
import sys

import numpy as np

from .config import EncoderConfig
from .tables import mpeg

_MODES = {"s": mpeg.MODE_STEREO, "d": mpeg.MODE_DUAL,
          "j": mpeg.MODE_JOINT, "m": mpeg.MODE_MONO}
_EMPH = {"n": 0, "5": 1, "c": 3}


def build_parser():
    p = argparse.ArgumentParser(
        prog="mp3tpu",
        description="JAX MPEG-1/2 audio encoder (Layers I/II/III)")
    p.add_argument("-l", dest="layer", type=int, default=3,
                   choices=(1, 2, 3), help="layer (default 3)")
    p.add_argument("-m", dest="mode", default="s", choices=sorted(_MODES),
                   help="channel mode: s/d/j/m (default s)")
    p.add_argument("-p", dest="psy", type=int, default=2, choices=(1, 2),
                   help="psychoacoustic model (default 2)")
    p.add_argument("-s", dest="sfrq", type=float, default=None,
                   help="input sample rate in kHz (overrides header)")
    p.add_argument("-b", dest="brate", type=int, default=0,
                   help="total bitrate in kbps (default: index 9)")
    p.add_argument("-d", dest="emp", default="n", choices=sorted(_EMPH),
                   help="de-emphasis n/5/c (default n)")
    p.add_argument("-c", dest="copyright", action="store_true",
                   help="mark as copyright")
    p.add_argument("-o", dest="original", action="store_true",
                   help="mark as original")
    p.add_argument("-e", dest="error_protection", action="store_true",
                   help="add CRC error protection")
    p.add_argument("-L", dest="little_endian", action="store_true",
                   help="raw PCM data is little endian")
    p.add_argument("--exact", action="store_true",
                   help="use the byte-exact oracle encoder")
    p.add_argument("input", help="WAV, AIFF, raw PCM file, or '-'")
    p.add_argument("output", nargs="?", default=None,
                   help="output stream (default: input + .mp3)")
    return p


def stdin_pcm_iter(little_endian, nch=1, chunk_bytes=1 << 20):
    """Yield (nch, n) int16 blocks from stdin until EOF -- the
    reference's 'inf' streaming mode (musicin.c:310-312) reads
    channel-interleaved PCM at the configured mode (stereo by default,
    encoder.h:64 DFLT_MOD 's'; interleaved read encode.c:139-160).
    O(chunk) memory; trailing bytes short of one interleaved frame are
    dropped like a short final fread."""
    dt = "<i2" if little_endian else ">i2"
    frame = 2 * nch
    carry = b""
    while True:
        raw = sys.stdin.buffer.read(chunk_bytes)
        if not raw:
            break
        raw = carry + raw
        usable = len(raw) - (len(raw) % frame)
        carry = raw[usable:]
        if usable:
            flat = np.frombuffer(raw[:usable], dtype=dt).astype(np.int16)
            yield flat.reshape(-1, nch).T


def _deinterleave_raw(raw, args):
    """Raw PCM is channel-interleaved at the configured mode
    (encode.c:139-160 reads `stereo` samples per frame; stereo default
    per encoder.h:64) -- returns (n, nch) int16."""
    nch = 1 if _MODES[args.mode] == mpeg.MODE_MONO else 2
    dt = "<i2" if args.little_endian else ">i2"
    flat = np.frombuffer(raw, dtype=dt).astype(np.int16)
    usable = len(flat) - (len(flat) % nch)
    return flat[:usable].reshape(-1, nch)


def read_input(args):
    """Returns (pcm int16 (n, nch), rate_hz or None)."""
    if args.input == "-":
        return _deinterleave_raw(sys.stdin.buffer.read(), args), None
    with open(args.input, "rb") as f:
        head = f.read(12)
    if head[:4] == b"FORM" and head[8:12] == b"AIFF":
        from .runtime.aiff import read_aiff
        pcm, rate = read_aiff(args.input)
        print(f">>> Using Audio IFF sound file headers ({rate:.1f} Hz)",
              file=sys.stderr)
        return pcm, rate
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        from .runtime.wav import read_wav
        pcm, rate = read_wav(args.input)
        return pcm, float(rate)
    # raw PCM
    return _deinterleave_raw(open(args.input, "rb").read(), args), None


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.input == "-" and not args.exact:
        # streaming stdin, ALL layers: unbounded channel-interleaved
        # input at the configured mode (stereo by default like
        # encoder.h:64), O(window) memory (musicin.c:310-371 'inf'
        # mode; encode.c:123-168 interleaved block reads)
        rate = (args.sfrq * 1000.0) if args.sfrq is not None else 44100.0
        mode = _MODES[args.mode]
        if args.layer == 3 and mode == mpeg.MODE_JOINT:
            print("joint stereo is not defined for layer 3 "
                  "(musicin.c:548-552)", file=sys.stderr)
            return 1
        cfg = EncoderConfig(
            layer=args.layer, mode=mode, psy_model=args.psy,
            bitrate_kbps=args.brate, sample_rate_hz=rate,
            emphasis=_EMPH[args.emp], copyright=args.copyright,
            original=args.original,
            error_protection=args.error_protection)
        cfg.finalize()
        if args.layer == 3 and args.psy != 2:
            print("psychoacoustic model 1 is not defined for layer 3",
                  file=sys.stderr)
            return 1
        if args.layer == 3:
            from .encoder import encode_layer3_stream as enc_stream
        else:
            from .encoder import encode_layer12_stream as enc_stream
        total = 0
        # no output path: pipe MP3 bytes to stdout (the natural pipe
        # semantics; '-.mp3' would be a footgun for downstream tools)
        sink = (open(args.output, "wb") if args.output
                else sys.stdout.buffer)
        try:
            for chunk in enc_stream(
                    stdin_pcm_iter(args.little_endian,
                                   nch=cfg.nchannels), cfg):
                sink.write(chunk)
                total += len(chunk)
            sink.flush()
        finally:
            if args.output:
                sink.close()
        print(f">>> streamed {total} bytes", file=sys.stderr)
        return 0

    pcm, rate = read_input(args)
    if args.sfrq is not None:
        rate = args.sfrq * 1000.0
    if rate is None:
        rate = 44100.0

    mode = _MODES[args.mode]
    nch_in = pcm.shape[1] if pcm.ndim == 2 else 1
    if nch_in == 1 and mode != mpeg.MODE_MONO:
        mode = mpeg.MODE_MONO
    if mode == mpeg.MODE_MONO and nch_in == 2:
        pcm = pcm[:, :1]

    cfg = EncoderConfig(
        layer=args.layer, mode=mode, psy_model=args.psy,
        bitrate_kbps=args.brate, sample_rate_hz=rate,
        emphasis=_EMPH[args.emp], copyright=args.copyright,
        original=args.original, error_protection=args.error_protection)
    cfg.finalize()

    out_path = args.output or (args.input + ".mp3")
    secs = pcm.shape[0] / rate
    print(f">>> layer {cfg.layer}, {cfg.bitrate_kbps} kbps, "
          f"{rate / 1000.0:g} kHz, mode {args.mode}, psy {args.psy}, "
          f"{secs:.1f} s", file=sys.stderr)

    if args.layer == 3:
        if args.psy != 2:
            print("psychoacoustic model 1 is not defined for layer 3 "
                  "(musicin.c:554-558)", file=sys.stderr)
            return 1
        if mode == mpeg.MODE_JOINT:
            print("joint stereo is not defined for layer 3 "
                  "(musicin.c:548-552)", file=sys.stderr)
            return 1
        if args.exact:
            from .numpy_ref.encoder import encode_layer3
            data = encode_layer3(pcm, cfg)
        else:
            from .encoder import encode_layer3_fast
            from .runtime import profiling
            prof = profiling.from_env()
            data = encode_layer3_fast(pcm, cfg, prof=prof)
            m = prof.meta
            if m:
                # reference-style self-accounting (musicin.c:807-811)
                fsize = len(data) / max(m["frames"], 1)
                print(f">>> Avg slots/frame = {fsize / 1:.2f}; "
                      f"bitrate = {m['kbps']:.2f} kbps; "
                      f"{m['frames']} frames"
                      + (f"; {m['nonfinite_granules']} granules "
                         "degraded to silence (non-finite analysis)"
                         if m["nonfinite_granules"] else ""),
                      file=sys.stderr)
    else:
        cfg.psy_model = args.psy
        if args.exact:
            from .numpy_ref.layer12 import encode as encode12
            data = encode12(pcm, cfg)
        else:
            from .encoder import encode_layer12_fast
            data = encode_layer12_fast(pcm, cfg)

    with open(out_path, "wb") as f:
        f.write(data)
    print(f">>> wrote {len(data)} bytes to {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
