"""Packaging (reference §2.13: setup.py + console entry point)."""
from setuptools import find_packages, setup

setup(
    name="yolov3-tpu",
    version="0.1.0",
    description="TPU-native YOLOv3 inference framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["yolov3_tpu", "yolov3_tpu.*",
                                    "yolov3_tpu_torch", "yolov3_tpu_torch.*"]),
    package_data={"yolov3_tpu": ["py.typed"],
                  "yolov3_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
        "opencv-python",
    ],
    entry_points={
        "console_scripts": [
            "yolov3-tpu = yolov3_tpu.__main__:main",
        ],
    },
)
