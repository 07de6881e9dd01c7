"""Build the native core: ``python -m lorastencil.native.build``.

Uses cmake + the default generator; falls back to a direct g++ invocation
if cmake is unavailable.
"""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(__file__)


def build() -> str:
    out = os.path.join(HERE, "liblorastencil_core.so")
    if shutil.which("cmake"):
        bdir = os.path.join(HERE, "build")
        subprocess.run(["cmake", "-S", HERE, "-B", bdir,
                        "-DCMAKE_BUILD_TYPE=Release"], check=True)
        subprocess.run(["cmake", "--build", bdir, "-j"], check=True)
    else:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
             "-fPIC", os.path.join(HERE, "src", "lorastencil_core.cc"),
             "-o", out],
            check=True,
        )
    assert os.path.exists(out), out
    return out


if __name__ == "__main__":
    print(build())
    sys.exit(0)
