from fealess.ops import image, luts, quantize, response, similarity  # noqa: F401

__all__ = ["image", "luts", "quantize", "response", "similarity"]
