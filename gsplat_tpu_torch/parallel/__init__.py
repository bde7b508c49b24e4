"""Distributed rendering over a process group (parallel/render.py)."""

from .render import rasterization_sharded

__all__ = ["rasterization_sharded"]
