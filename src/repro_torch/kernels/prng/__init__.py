from .threefry_kernel import SOURCES, threefry_cost, threefry_draw

__all__ = ["SOURCES", "threefry_cost", "threefry_draw"]
