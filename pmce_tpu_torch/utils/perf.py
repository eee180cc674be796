"""The port's record of measured performance: ``PERF_TORCH.json``.

Port of ``pmce_tpu/utils/perf.py``'s recorder. The JAX package's
``PERF.json`` and the README block generated from it
(``tests/test_perf_docs.py`` holds the two together) belong to the JAX
package: this module never writes either. Its default file is
``PERF_TORCH.json`` at the repository root (git-ignored): every entry is
a measurement of one run on one device, stamped with that device (on the
card: its name and power limit, as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives them) and the time.

Writers: ``bench_torch.py --record-perf`` (``serving``), ``python -m
pmce_tpu_torch.main.run_demo ... --record-perf`` (``demo_full_stack``,
``demo_real_footage``) and the converter CLIs ``python -m
pmce_tpu_torch.tools.convert_* ... --record-perf`` (``etl``, one entry a
dataset split). Each writes only when asked. A write is a
read-modify-write of one key with an atomic replace, as JAX's.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PERF_PATH = os.path.join(_REPO_ROOT, "PERF_TORCH.json")


def device_stamp(device=None) -> str:
    """What ran the measurement: a card's name and power limit from
    nvidia-smi, else ``cpu``."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return lines[min(device.index or 0, len(lines) - 1)]


def load(path: str | None = None) -> dict:
    path = path or PERF_PATH
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def record(key: str, payload: dict, path: str | None = None, device=None,
           sub: str | None = None) -> dict:
    """Merge ``payload``, stamped with ``device`` and the time, under
    ``key`` (under ``key`` → ``sub`` when given: one entry a dataset
    split) and replace the file atomically. Returns the file's data."""
    path = path or PERF_PATH
    data = load(path)
    entry = dict(payload)
    entry.setdefault("device", device_stamp(device))
    entry.setdefault("measured_unix", round(time.time(), 1))
    if sub is None:
        data[key] = entry
    else:
        data.setdefault(key, {})[sub] = entry
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return data


def _stages(entry: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
        entry["stage_seconds"].items(), key=lambda kv: -kv[1]))


def render_table(data: dict | None = None) -> str:
    """A markdown table of the port's entries (``serving``,
    ``demo_full_stack``, ``demo_real_footage``, ``etl``), each row's
    device beside its numbers. The counterpart of JAX's
    ``render_readme_table``; it splices nothing into the README."""
    d = data if data is not None else load()
    lines = ["| Quantity | Value | Device |", "|---|---|---|"]
    s = d.get("serving")
    if s:
        extra = (f"; {s['device_ms']:.3f} ms of kernels a forward"
                 if s.get("device_ms") is not None else "")
        lines.append(
            f"| PMCE serving, batch {s['batch']}, bf16 on its kernels "
            f"(`{s['source']}`) | {s['mid_frames_per_s']:,.1f} "
            f"mid-frames/s{extra} | {s['device']} |")
    for key, what in (("demo_full_stack", "video demo, full stack"),
                      ("demo_real_footage", "video demo, real footage")):
        e = d.get(key)
        if e:
            lines.append(
                f"| {what} ({e['config']}) | {e['fps_measured']:.1f} "
                f"frames/s over {e['n_frames']} frames (stages: "
                f"{_stages(e)}) | {e['device']} |")
    for split, e in sorted(d.get("etl", {}).items()):
        lines.append(
            f"| ETL {split} (`{e['source']}`) | {e['frames']} frames in "
            f"{e['seconds']:.2f} s = {e['frames_per_s']:,.1f} frames/s | "
            f"{e['device']} |")
    return "\n".join(lines)
