#!/usr/bin/env python
"""Dump video frames to numbered PNGs: the port's ingest entry, its own
copy of the repository's ``video2img.py``. cv2.

    python -m onepose_tpu_torch.video2img --input Frames.m4v --output color_full/ [--downsample 1]
"""
import argparse
import os


def video2img(video_path: str, outdir: str, downsample: int = 1):
    import cv2

    os.makedirs(outdir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    index = 0
    written = 0
    while True:
        ret, image = cap.read()
        if not ret:
            break
        if index % downsample == 0:
            cv2.imwrite(
                os.path.join(outdir, f"{index // downsample}.png"), image)
            written += 1
        index += 1
    cap.release()
    print(f"[video2img] wrote {written} frames to {outdir}")
    return written


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--downsample", type=int, default=1)
    args = ap.parse_args()
    video2img(args.input, args.output, args.downsample)


if __name__ == "__main__":
    main()
