from gvr.io.ppm import read_ppm, write_ppm
from gvr.io.gif import write_gif

__all__ = ["read_ppm", "write_ppm", "write_gif"]
