"""Scene datasets of the port: the COLMAP parser (datasets/colmap.py)."""

from .colmap import Dataset, Parser, decode_png, encode_png, load_image, write_model_binary

__all__ = ["Dataset", "Parser", "decode_png", "encode_png", "load_image", "write_model_binary"]
