"""Build and load the package's CUDA kernels at first use.

Each `csrc/<name>.cu` exposes a plain C launcher. It is compiled for sm_90a
by `torch.utils.cpp_extension.load` into `_build/kernels/<name>/` (listed
in .gitignore; one directory per source, so that builds started together
from several threads do not wait on one lock file) and opened with ctypes.
The sources include no PyTorch header, so a build takes seconds. A failed
build raises.
"""

from __future__ import annotations

import ctypes
import os

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_libs: dict = {}


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (once per process and source version) and
    return the loaded shared library."""
    lib = _libs.get(name)
    if lib is None:
        from torch.utils.cpp_extension import load

        build_dir = os.path.join(BUILD_DIR, name)
        os.makedirs(build_dir, exist_ok=True)
        path = load(
            name=name,
            sources=[os.path.join(CSRC_DIR, f"{name}.cu")],
            build_directory=build_dir,
            extra_cuda_cflags=CUDA_FLAGS,
            is_python_module=False,
            verbose=False,
        )
        lib = _libs[name] = ctypes.CDLL(path)
    return lib
