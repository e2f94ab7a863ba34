"""Output sinks reproducing the reference's persisted artifacts:
counterpart of ``lk_tpu.io.sink`` (numpy, csv and pickle only).

* ``save_vp_csv`` — ``vps/vps_<name>.csv`` with header ``x,y`` and one row
  per VP update plus one per shown frame (reference LK_Final.py:384-388,722;
  duplicate-row semantics documented in SURVEY.md §2.3).
* ``save_segments_pickle`` — the ``line_segments.pkl`` equivalent: a list of
  plain dict records (start, stop, vector, length, angle) rather than
  unpicklable ad-hoc class instances (reference LK_Final.py:375-377).
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def save_object(obj, filename: str) -> str:
    """Generic pickle dump (reference save_object, LK_Final.py:375-377)."""
    with open(filename, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
    return filename


def read_object(filename: str):
    """Generic pickle load (reference read_object, LK_Final.py:379-382)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def save_vp_csv(rows: Sequence[Tuple[float, float]], name: str,
                out_dir: str = "./vps") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"vps_{name}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["x", "y"])
        w.writerows(rows)
    return path


def read_vp_csv(name_or_path: str, out_dir: str = "./vps"):
    path = (
        name_or_path
        if name_or_path.endswith(".csv")
        else os.path.join(out_dir, f"vps_{name_or_path}.csv")
    )
    xs: List[float] = []
    ys: List[float] = []
    with open(path) as f:
        rows = csv.reader(f)
        next(rows, None)
        for row in rows:
            xs.append(float(row[0]))
            ys.append(float(row[1]))
    return xs, ys


def save_segments_pickle(segments: Iterable[dict], path: str) -> str:
    recs = []
    for s in segments:
        start = np.asarray(s["start"], np.float32)
        stop = np.asarray(s["stop"], np.float32)
        vec = (stop - start) * np.array([1, -1], np.float32)
        recs.append(
            dict(
                start=start,
                stop=stop,
                vector=vec,
                length=float(np.round(np.linalg.norm(vec), 2)),
                angle=float(
                    (np.degrees(np.arccos(np.clip(
                        vec[0] / max(np.linalg.norm(vec), 1e-12), -1, 1)))
                     if np.linalg.norm(vec) > 0 else 0.0)
                    if vec[1] >= 0
                    else 360.0 - np.degrees(np.arccos(np.clip(
                        vec[0] / max(np.linalg.norm(vec), 1e-12), -1, 1)))
                ),
            )
        )
    with open(path, "wb") as f:
        pickle.dump(recs, f, pickle.HIGHEST_PROTOCOL)
    return path
