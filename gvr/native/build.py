"""Build the native runtime library: python -m gvr.native.build

The shared object is built from ``gvr_native.cpp`` into
``<checkout>/build/native/`` (gitignored), at first use by
``loader.lib()`` or by this command.
"""

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                       "native")
SO_PATH = os.path.join(OUT_DIR, "libgvr_native.so")


def build(verbose=True):
    """Compile to a temporary file and move it into place, so concurrent
    first uses never load a half-written library."""
    src = os.path.join(HERE, "gvr_native.cpp")
    os.makedirs(OUT_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=OUT_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared",
           "-o", tmp, src]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.check_call(cmd, stdout=subprocess.DEVNULL)
        os.replace(tmp, SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return SO_PATH


if __name__ == "__main__":
    sys.exit(0 if os.path.exists(build()) else 1)
