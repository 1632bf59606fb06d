"""logread: unified-log export CLI.

Port of the reference's ``logread`` binary
(``/root/reference/crates/chalkydri/src/bin/logread.rs:1-9``: Copper
unified-log export): dump a .ctlog session as JSON lines, extract frames to
PNGs, or replay frames through the detect->pose pipeline offline.

Run:  python -m chalkydri_tpu.tools.logread dump session.ctlog
      python -m chalkydri_tpu.tools.logread frames session.ctlog --out dir/
      python -m chalkydri_tpu.tools.logread replay session.ctlog
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_dump(args) -> int:
    from chalkydri_tpu.runtime.logging import read_log

    for rec in read_log(args.log):
        out = dict(rec)
        if rec["kind"] == "frame":
            out["frame"] = f"<{rec['frame'].shape[0]}x{rec['frame'].shape[1]} u8>"
        elif rec["kind"] == "pose":
            p, s = rec["pose"], rec["std"]
            out["pose"] = {"x": p.x, "y": p.y, "rot": p.rot}
            out["std"] = {"x": s.x, "y": s.y, "rot": s.rot}
        print(json.dumps(out, default=str))
    return 0


def cmd_frames(args) -> int:
    import cv2

    from chalkydri_tpu.runtime.logging import replay_frames

    os.makedirs(args.out, exist_ok=True)
    n = 0
    for cam, tov, frame in replay_frames(args.log):
        cv2.imwrite(os.path.join(args.out, f"cam{cam}_{n:06d}.png"), frame)
        n += 1
    print(f"wrote {n} frames to {args.out}")
    return 0


def cmd_replay(args) -> int:
    """Re-run logged frames through the detector (offline debugging —
    the record/replay loop SURVEY.md section 5.4 calls for)."""
    import jax.numpy as jnp
    import numpy as np

    from chalkydri_tpu.detector import make_detector
    from chalkydri_tpu.runtime.logging import replay_frames

    detect = make_detector()
    n = 0
    for cam, tov, frame in replay_frames(args.log):
        h = (frame.shape[0] + 7) // 8 * 8
        w = (frame.shape[1] + 7) // 8 * 8
        buf = np.full((h, w), 127, np.uint8)
        buf[: frame.shape[0], : frame.shape[1]] = frame
        out = detect(jnp.asarray(buf)[None])
        ids = [int(i) for i in np.asarray(out.ids[0]) if i >= 0]
        print(json.dumps({"cam": cam, "tov_us": tov, "ids": ids}))
        n += 1
    print(f"# replayed {n} frames", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="logread")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("log")
    d.set_defaults(fn=cmd_dump)
    f = sub.add_parser("frames")
    f.add_argument("log")
    f.add_argument("--out", default="frames")
    f.set_defaults(fn=cmd_frames)
    r = sub.add_parser("replay")
    r.add_argument("log")
    r.set_defaults(fn=cmd_replay)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
