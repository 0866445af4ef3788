from .threefry_kernel import SOURCES, threefry_draw

__all__ = ["SOURCES", "threefry_draw"]
