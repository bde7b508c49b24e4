from .geometry import depth_to_normal, depth_to_points

__all__ = ["depth_to_normal", "depth_to_points"]
