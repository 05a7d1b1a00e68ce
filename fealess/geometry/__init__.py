from fealess.geometry import depth, transforms  # noqa: F401

__all__ = ["depth", "transforms"]
