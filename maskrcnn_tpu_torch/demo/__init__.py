"""The demo: COCODemo (predictor.py), its drawing (draw.py) and the webcam
loop (webcam.py)."""

from .predictor import COCODemo

__all__ = ["COCODemo"]
