"""Video IO over ffmpeg pipes (reference wm_basicsr/utils/video_util.py:
29-129), ported from comfyui_keep_tpu/utils/video.py without its OpenCV
branch: VideoReader probes the file with ffprobe and reads raw bgr24
frames from an `ffmpeg ... -f rawvideo pipe:1` process; VideoWriter feeds
raw bgr24 frames to `ffmpeg -f rawvideo -i pipe:0 -c:v libx264 -crf <crf>
-pix_fmt yuv420p`. The binaries are looked up on PATH when a reader or
writer is made; without them it raises an error that names them.
"""
import json
import os
import shutil
import subprocess
from typing import Optional

import numpy as np


def _binary(name: str, who: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{who} needs the `{name}` binary on PATH (ffmpeg "
                           "and ffprobe); none was found")
    return path


class VideoReader:
    def __init__(self, video_path):
        self.path = video_path
        ffprobe = _binary("ffprobe", "VideoReader")
        ffmpeg = _binary("ffmpeg", "VideoReader")
        probe = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height,r_frame_rate,nb_frames",
             "-of", "json", self.path], capture_output=True, check=True)
        info = json.loads(probe.stdout)["streams"][0]
        self.width = int(info["width"])
        self.height = int(info["height"])
        num, den = info["r_frame_rate"].split("/")
        self.fps = float(num) / float(den)
        self.nb_frames = int(info.get("nb_frames", 0))
        self.proc = subprocess.Popen(
            [ffmpeg, "-i", self.path, "-f", "rawvideo", "-pix_fmt", "bgr24",
             "-loglevel", "error", "pipe:1"], stdout=subprocess.PIPE)

    def __len__(self):
        return self.nb_frames

    def get_fps(self):
        return self.fps

    def get_frame(self) -> Optional[np.ndarray]:
        """The next (H, W, 3) uint8 BGR frame, None after the last."""
        size = self.width * self.height * 3
        raw = self.proc.stdout.read(size)
        if len(raw) < size:
            return None
        return np.frombuffer(raw, np.uint8).reshape(self.height, self.width,
                                                    3)

    def close(self):
        self.proc.stdout.close()
        self.proc.wait()


class VideoWriter:
    def __init__(self, video_save_path, height, width, fps=25, audio=None,
                 crf=18):
        self.path = video_save_path
        self.height, self.width, self.fps = height, width, fps
        ffmpeg = _binary("ffmpeg", "VideoWriter")
        os.makedirs(os.path.dirname(os.path.abspath(video_save_path)),
                    exist_ok=True)
        self.proc = subprocess.Popen(
            [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "bgr24",
             "-s", f"{width}x{height}", "-r", str(fps), "-i", "pipe:0",
             "-c:v", "libx264", "-crf", str(crf), "-pix_fmt", "yuv420p",
             "-loglevel", "error", video_save_path], stdin=subprocess.PIPE)

    def write_frame(self, frame_bgr_u8: np.ndarray):
        """Append an (H, W, 3) uint8 BGR frame."""
        frame = np.asarray(frame_bgr_u8)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"a frame of {frame.shape}, the video is "
                             f"{(self.height, self.width, 3)}")
        self.proc.stdin.write(frame.astype(np.uint8).tobytes())

    def close(self):
        """Finish the file; raises if ffmpeg failed."""
        self.proc.stdin.close()
        code = self.proc.wait()
        if code != 0:
            raise RuntimeError(f"ffmpeg exited with {code} writing "
                               f"{self.path}")
