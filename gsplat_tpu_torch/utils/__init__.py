from .data import load_test_data, synthetic_test_data
from .geometry import depth_to_normal, depth_to_points
from .trace import trace_function, trace_pop, trace_push, trace_range

__all__ = [
    "depth_to_normal",
    "depth_to_points",
    "load_test_data",
    "synthetic_test_data",
    "trace_function",
    "trace_pop",
    "trace_push",
    "trace_range",
]
