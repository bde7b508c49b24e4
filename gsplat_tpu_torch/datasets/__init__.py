"""Scene datasets of the port: the COLMAP parser (datasets/colmap.py) and
the render trajectories (datasets/traj.py)."""

from .colmap import (
    Dataset,
    Parser,
    decode_png,
    decode_png_channels,
    encode_png,
    load_image,
    write_model_binary,
)

__all__ = ["Dataset", "Parser", "decode_png", "decode_png_channels", "encode_png", "load_image",
           "write_model_binary"]
