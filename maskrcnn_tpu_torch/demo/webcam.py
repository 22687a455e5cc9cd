"""Webcam demo: COCODemo over a camera's frames.

    python -m maskrcnn_tpu_torch.demo.webcam [--config-file FILE]
        [--confidence-threshold T] [--min-image-size S] [KEY VALUE ...]

Port of the JAX package's demo/webcam.py. ``run`` is the loop over any
iterable of BGR uint8 frames, handing each drawn frame to a sink, so that
it runs without a camera; ``main`` alone imports OpenCV, for the capture and
the window (Esc quits).
"""

import argparse
import time

from ..config import cfg as default_cfg
from .predictor import COCODemo


def run(demo, frames, sink):
    """Draw every frame of `frames` with `demo` and call sink(composite,
    seconds); stops early when the sink returns True. Returns the number
    of frames drawn."""
    n = 0
    for img in frames:
        start = time.time()
        composite = demo.run_on_opencv_image(img)
        n += 1
        if sink(composite, time.time() - start):
            break
    return n


def camera_frames(cam):
    while True:
        ok, img = cam.read()
        if not ok:
            return
        yield img


def main(argv=None):
    parser = argparse.ArgumentParser(description="Webcam demo")
    parser.add_argument("--config-file", default="configs/e2e_mask_rcnn_R_50_FPN_1x.yaml",
                        metavar="FILE")
    parser.add_argument("--confidence-threshold", type=float, default=0.7)
    parser.add_argument("--min-image-size", type=int, default=224)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = default_cfg.clone()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    demo = COCODemo(cfg, confidence_threshold=args.confidence_threshold,
                    min_image_size=args.min_image_size)

    import cv2

    def show(composite, seconds):
        print("Time: {:.2f} s / img".format(seconds))
        cv2.imshow("COCO detections", composite)
        return cv2.waitKey(1) == 27  # esc to quit

    cam = cv2.VideoCapture(0)
    try:
        run(demo, camera_frames(cam), show)
    finally:
        cam.release()
        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
