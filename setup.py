"""Packaging for cython3dmodelrenderer_tpu.

The native OBJ parser (native/objparse.cpp) is built lazily at import time
via g++ + ctypes (no compile-time dependency); ship the source with the
package. Reference equivalent: the Cython build in the reference's setup.py
(setup.py:8-16) — here the compute path is JAX/Pallas, so there is nothing
to cythonize.

The PyTorch + CUDA port (cython3dmodelrenderer_tpu_torch) ships its CUDA
sources (csrc/*.cu); nvcc builds them into build/kernels/ at first launch.
"""
from setuptools import find_packages, setup

setup(
    name="cython3dmodelrenderer-tpu",
    version="0.1.0",
    description="TPU-native 3D software rasterizer (JAX/XLA/Pallas)",
    packages=find_packages(include=["cython3dmodelrenderer_tpu*",
                                    "cython3dmodelrenderer_tpu_torch*"]),
    package_data={"cython3dmodelrenderer_tpu.native": ["*.cpp"],
                  "cython3dmodelrenderer_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "opencv-python-headless",
        "tqdm",
    ],
    # the PyTorch + CUDA port: torch and numpy only
    extras_require={"torch": ["torch", "numpy"]},
)
