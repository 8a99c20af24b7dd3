"""Build hook: compile the native I/O runtime into the package.

The shared library (native/eppm_io.cpp — PPM/PGM + Middlebury .flo
codecs, threaded batch decoder, PNG unfilter; see SURVEY.md §2.5/2.6)
is a plain ctypes library, not a CPython extension, so it is built with
the Makefile and shipped as package data.  The build is best-effort:
eppm/io/native.py falls back to the pure-Python codecs when the
library is missing, so a toolchain-less install still works.
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        root = os.path.dirname(os.path.abspath(__file__))
        native = os.path.join(root, "native")
        so = os.path.join(native, "libeppm_io.so")
        try:
            subprocess.run(
                ["make", "-C", native], capture_output=True,
                timeout=300, check=False,
            )
        except (OSError, subprocess.SubprocessError):
            pass
        if os.path.exists(so):
            shutil.copy2(so, os.path.join(root, "eppm", "libeppm_io.so"))
        super().run()


setup(cmdclass={"build_py": BuildWithNative})
