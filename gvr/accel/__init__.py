from gvr.accel.grid import GridIndex, build_grid, dda_crossings

__all__ = ["GridIndex", "build_grid", "dda_crossings"]
