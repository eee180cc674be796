"""Video decode/encode via an ffmpeg pipe, plus array-backed sources.

Port of ``pmce_tpu/demo/video_io.py`` (numpy, unchanged).

Functional parity target: reference lib/utils/demo_utils.py:101-141
(``video_to_images`` / ``images_to_video`` ffmpeg subprocesses). Instead of
materializing every frame as a JPEG on disk, frames stream through an
ffmpeg rawvideo pipe directly into pinned host numpy buffers (one HBM-ready
array per chunk), which is what the double-buffered H2D prefetcher wants.

Environments without ffmpeg (like CI) use ``ArrayVideoSource`` /
``npy``-backed clips; every consumer takes the abstract source.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def probe_video(path: str) -> dict:
    """Width/height/fps/frame-count via ffprobe."""
    if shutil.which("ffprobe") is None:
        raise RuntimeError("ffprobe is not available on this machine")
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries",
         "stream=width,height,r_frame_rate,nb_read_packets",
         "-count_packets", "-of", "json", path],
        check=True, capture_output=True).stdout
    s = json.loads(out)["streams"][0]
    num, den = s["r_frame_rate"].split("/")
    return {
        "width": int(s["width"]), "height": int(s["height"]),
        "fps": float(num) / float(den),
        "num_frames": int(s.get("nb_read_packets", 0)),
    }


class FFmpegVideoSource:
    """Iterate RGB frames of a video file through an ffmpeg rawvideo pipe."""

    def __init__(self, path: str):
        if not has_ffmpeg():
            raise RuntimeError(
                "ffmpeg is not available; use ArrayVideoSource or an "
                "image-folder source instead")
        info = probe_video(path)
        self.width, self.height = info["width"], info["height"]
        self.fps = info["fps"]
        self.path = path

    def __iter__(self):
        proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-i", self.path, "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-"],
            stdout=subprocess.PIPE, bufsize=10 ** 8)
        frame_bytes = self.width * self.height * 3
        try:
            while True:
                buf = proc.stdout.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(
                    self.height, self.width, 3)
        finally:
            proc.stdout.close()
            proc.wait()


class FFmpegVideoWriter:
    """Encode RGB frames to a video file through an ffmpeg pipe."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 29.97):
        if not has_ffmpeg():
            raise RuntimeError("ffmpeg is not available")
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-y", "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-s", f"{width}x{height}",
             "-r", str(fps), "-i", "-", "-an", "-vcodec", "libx264",
             "-pix_fmt", "yuv420p", path],
            stdin=subprocess.PIPE)

    def write(self, frame: np.ndarray) -> None:
        self._proc.stdin.write(np.ascontiguousarray(frame, np.uint8)
                               .tobytes())

    def close(self) -> None:
        self._proc.stdin.close()
        self._proc.wait()


class ArrayVideoSource:
    """In-memory frame sequence with the same source interface."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0):
        self.frames = np.asarray(frames, np.uint8)
        self.height, self.width = self.frames.shape[1:3]
        self.fps = fps

    def __iter__(self):
        return iter(self.frames)

    def __len__(self):
        return len(self.frames)


class ArrayVideoWriter:
    """Collects frames into memory (test double for FFmpegVideoWriter)."""

    def __init__(self):
        self.frames: list = []

    def write(self, frame: np.ndarray) -> None:
        self.frames.append(np.asarray(frame, np.uint8).copy())

    def close(self) -> None:
        pass


def open_video(path_or_frames) -> object:
    """Open any supported source: array, .npy path, or video file."""
    if isinstance(path_or_frames, np.ndarray):
        return ArrayVideoSource(path_or_frames)
    if isinstance(path_or_frames, str) and path_or_frames.endswith(".npy"):
        return ArrayVideoSource(np.load(path_or_frames))
    if isinstance(path_or_frames, str) and os.path.isdir(path_or_frames):
        raise NotImplementedError(
            "image-folder sources need an image decoder; provide a video "
            "file or an .npy frame stack")
    return FFmpegVideoSource(str(path_or_frames))
