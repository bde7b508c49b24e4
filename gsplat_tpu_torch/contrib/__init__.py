"""Contributed components of the port (contrib/dynamic: G-SHARP dynamic scenes)."""
