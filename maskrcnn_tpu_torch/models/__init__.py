from .detector import GeneralizedRCNN, build_detection_model

__all__ = ["GeneralizedRCNN", "build_detection_model"]
