"""Dump a clip's video payloads to a flat file for the C++ planner bench.

The counterpart of `tools/dump_payloads.py`, on the port's `Demuxer`
(`hvqm4_tpu_torch.container`); it imports nothing of the JAX package and
writes the same bytes.

Format: u32 width, height, h_samp, v_samp, then u32 n_frames, then per
frame: u8 ftype (0=I 1=P 2=B), u32 size, payload bytes (little-endian).

Usage: python tools/dump_payloads_torch.py clip.h4m payloads.bin
"""
import pathlib
import struct
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from hvqm4_tpu_torch.container import Demuxer  # noqa: E402

_CODE = {"I": 0, "P": 1, "B": 2}


def main() -> None:
    clip, out = sys.argv[1], sys.argv[2]
    d = Demuxer(open(clip, "rb").read())
    cfg = d.info.cfg
    recs = [(r.frame_char, r.payload) for r in d.video_records()]
    with open(out, "wb") as f:
        f.write(struct.pack("<IIII", cfg.width, cfg.height,
                            cfg.h_samp, cfg.v_samp))
        f.write(struct.pack("<I", len(recs)))
        for fchar, payload in recs:
            f.write(struct.pack("<BI", _CODE[fchar], len(payload)))
            f.write(payload)
    print(f"wrote {out}: {len(recs)} frames, {cfg.width}x{cfg.height}")


if __name__ == "__main__":
    main()
