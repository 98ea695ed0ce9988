"""CLI: container conversion, the port's `convert`.

    python -m tomatis_tpu_torch.cli.main convert -i out.wav -o out.flac

The processors fall back to WAV when FLAC cannot be encoded and print
this command as the way back. Streams in 30 s blocks (bounded memory on
hour-long files). A source of at most 24 bits going to a PCM_24 sink is
copied as integers (read_int24 -> write_raw: no float round trip);
anything else goes through float32, which rounds once for narrower
targets. Host only: no device work, so no --device flag.
"""
from __future__ import annotations

import argparse
import sys

_BLOCK = 48000 * 30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "tomatis_tpu_torch convert",
        description="convert audio between the package's containers "
                    "(WAV/FLAC)")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--subtype", default="PCM_24",
                    choices=("PCM_16", "PCM_24", "PCM_32", "FLOAT"),
                    help="output sample format (FLAC supports PCM_16/24)")
    args = ap.parse_args(argv)

    from tomatis_tpu_torch.io import audio
    from tomatis_tpu_torch.utils.pcm import le24_from_i32

    total = 0
    with audio.AudioFile(args.input, "r") as fin, \
            audio.AudioFile(args.output, "w", samplerate=fin.samplerate,
                            channels=fin.channels,
                            subtype=args.subtype) as fout:
        lossless = fin.int24_readable and fout.supports_raw
        while True:
            if lossless:
                v = fin.read_int24(_BLOCK)
                if len(v) == 0:
                    break
                fout.write_raw(le24_from_i32(v.reshape(-1)))
                total += len(v)
            else:
                x = fin.read(_BLOCK)
                if len(x) == 0:
                    break
                fout.write(x)
                total += len(x)
        sr = fin.samplerate
    path_mode = "raw 24-bit copy" if lossless else "float32"
    print(f"{args.input} -> {args.output}: {total} samples/ch @ {sr} Hz, "
          f"{args.subtype} ({path_mode})")
    return 0

if __name__ == "__main__":
    sys.exit(main())
