from fealess.io import linemod_yaml  # noqa: F401

__all__ = ["linemod_yaml"]
