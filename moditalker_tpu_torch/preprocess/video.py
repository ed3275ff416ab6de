"""Video preparation utilities, host-side ffmpeg (a copy of
``moditalker_tpu/preprocess/video.py``; ref
data/data_utils/preprocess/unify_fps.py and video2frame_hdtf.py): thin
subprocess wrappers with a multiprocessing fan-out, in the reference's
output layout ({out_root}/{identity}/{frame:05d}.jpg).
"""

from __future__ import annotations

import os
import subprocess
import multiprocessing

# "spawn", never the Linux-default "fork": the corpus drivers run inside
# processes that may already hold thread pools (torch's, the test suite's),
# and forking a multi-threaded process can deadlock the child. The workers
# only shell out to ffmpeg, so spawn's import cost is irrelevant.
_MP = multiprocessing.get_context("spawn")
Pool = _MP.Pool


def _run(cmd: list[str]):
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.decode()[-400:])


def unify_fps(src: str, dst: str, fps: int = 25) -> str:
    """ref unify_fps.py:19 — re-encode at a fixed frame rate."""
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    _run(["ffmpeg", "-y", "-i", src, "-r", str(fps), dst])
    return dst


def video_to_frames(src: str, out_dir: str, quality: int = 2) -> str:
    """ref video2frame_hdtf.py — dump frames as {i:05d}.jpg."""
    os.makedirs(out_dir, exist_ok=True)
    _run(["ffmpeg", "-y", "-i", src, "-qscale:v", str(quality),
          "-start_number", "0", os.path.join(out_dir, "%05d.jpg")])
    return out_dir


def probe_fps(src: str) -> float:
    """ffprobe frame rate (ref video2frame_hdtf.py ffprobe call)."""
    proc = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=r_frame_rate", "-of",
         "default=noprint_wrappers=1:nokey=1", src],
        capture_output=True, text=True)
    num, den = proc.stdout.strip().split("/")
    return float(num) / float(den)


def batch_videos_to_frames(jobs: list[tuple[str, str]],
                           processes: int = 4) -> list[str]:
    """Parallel frame extraction (ref multiprocessing Pool)."""
    with Pool(processes) as pool:
        return pool.starmap(video_to_frames, jobs)


# ------------------------------------------------------------ corpus drivers
def corpus_videos(src_root: str) -> list[tuple[str, str]]:
    """Enumerate (identity, video path) under a corpus root. Accepts both
    the flat ``{id}.mp4`` layout (ref unify_fps.py walks a dir of mp4s) and
    the nested ``{id}/video.mp4`` layout (ref video2frame_hdtf.py:45)."""
    out = []
    for name in sorted(os.listdir(src_root)):
        p = os.path.join(src_root, name)
        if os.path.isfile(p) and name.lower().endswith((".mp4", ".avi",
                                                        ".mov", ".mkv")):
            out.append((os.path.splitext(name)[0], p))
        elif os.path.isdir(p) and os.path.isfile(
                os.path.join(p, "video.mp4")):
            out.append((name, os.path.join(p, "video.mp4")))
    return out


def _stripe(items, process_id: int, total_processes: int):
    """Multi-process striping, same convention as the keypoint/align corpus
    drivers (ref batchify.py:282-288)."""
    return items[process_id::total_processes]


def unify_fps_corpus(src_root: str, dst_root: str, fps: int = 25,
                     processes: int = 4, process_id: int = 0,
                     total_processes: int = 1,
                     skip_existing: bool = True) -> list[str]:
    """Re-encode every corpus video at a fixed fps (ref unify_fps.py:19
    as a runnable corpus pass). Writes ``{dst_root}/{id}.mp4``; resumable
    (existing outputs skipped) and stripeable across processes."""
    os.makedirs(dst_root, exist_ok=True)
    jobs = []
    for ident, src in _stripe(corpus_videos(src_root), process_id,
                              total_processes):
        dst = os.path.join(dst_root, f"{ident}.mp4")
        if skip_existing and os.path.exists(dst):
            continue
        jobs.append((src, dst, fps))
    with Pool(max(1, processes)) as pool:
        return pool.starmap(unify_fps, jobs)


def video_to_frames_corpus(src_root: str, dst_root: str, quality: int = 2,
                           processes: int = 4, process_id: int = 0,
                           total_processes: int = 1,
                           skip_existing: bool = True) -> list[str]:
    """Dump every corpus video to ``{dst_root}/{id}/{i:05d}.jpg`` (ref
    video2frame_hdtf.py with its multiprocessing Pool). Resumable: an
    identity dir that already holds jpgs is skipped."""
    os.makedirs(dst_root, exist_ok=True)
    jobs = []
    for ident, src in _stripe(corpus_videos(src_root), process_id,
                              total_processes):
        out_dir = os.path.join(dst_root, ident)
        if skip_existing and os.path.isdir(out_dir) and any(
                f.endswith(".jpg") for f in os.listdir(out_dir)):
            continue
        jobs.append((src, out_dir, quality))
    with Pool(max(1, processes)) as pool:
        return pool.starmap(video_to_frames, jobs)
