from .build import make_data_loader

__all__ = ["make_data_loader"]
