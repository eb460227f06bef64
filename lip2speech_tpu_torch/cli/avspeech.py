"""AVSpeech dataset acquisition tooling (JAX reference: cli/avspeech.py;
pure Python, no network).

Rebuild of reference avspeech.py:31-362 minus the network: parse the AVSpeech
CSV (id, start_s, end_s, face_x, face_y) and plan one yt-dlp download
command per segment of a usable duration. The commands are written to a
shell script, never run.
"""

from __future__ import annotations

import argparse
import csv
import json
import shlex
from dataclasses import dataclass
from pathlib import Path


@dataclass
class AVSpeechSegment:
    ytid: str
    start: float
    end: float
    face_x: float   # normalized face center
    face_y: float

    @property
    def clip_id(self) -> str:
        return f"{self.ytid}_{self.start:.2f}_{self.end:.2f}"


def parse_csv(path: str | Path) -> list[AVSpeechSegment]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 5:
                continue
            out.append(AVSpeechSegment(row[0], float(row[1]), float(row[2]),
                                       float(row[3]), float(row[4])))
    return out


def plan_download(segments: list[AVSpeechSegment], out_dir: str | Path,
                  min_duration: float = 1.0, max_duration: float = 24.0) -> list[str]:
    """yt-dlp + ffmpeg command lines for each valid segment."""
    cmds = []
    for s in segments:
        dur = s.end - s.start
        if not (min_duration <= dur <= max_duration):
            continue
        raw = Path(out_dir) / "raw" / f"{s.clip_id}.mp4"
        cmds.append(
            "yt-dlp -f 'bv*[height<=480]+ba' --download-sections "
            f"'*{s.start}-{s.end}' -o {shlex.quote(str(raw))} "
            f"https://www.youtube.com/watch?v={shlex.quote(s.ytid)}")
    return cmds


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--csv", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--script-path", default="download_avspeech.sh")
    args = p.parse_args(argv)
    segments = parse_csv(args.csv)
    cmds = plan_download(segments, args.out_dir)
    Path(args.script_path).write_text("#!/bin/sh\nset -e\n" + "\n".join(cmds) + "\n")
    out = {"segments": len(segments), "planned": len(cmds), "script": args.script_path}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
