from setuptools import find_packages, setup

setup(
    name="gsconverter-tpu",
    version="0.1.0",
    description=(
        "TPU-native Gaussian-splat processing and differentiable-rendering "
        "framework (JAX/XLA/Pallas), with the capabilities of 3dgsconverter"
    ),
    packages=find_packages(include=["gsconverter_tpu", "gsconverter_tpu.*",
                                    "gsconverter_tpu_torch", "gsconverter_tpu_torch.*"]),
    package_data={"gsconverter_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "tqdm",
    ],
    extras_require={
        "formats": ["pillow", "pandas", "pyarrow"],
        "test": ["pytest", "scipy", "scikit-learn"],
    },
    entry_points={
        # four aliases, mirroring the reference's console-script surface
        # (reference setup.py:28-35)
        "console_scripts": [
            "3dgsconverter-tpu=gsconverter_tpu.main:main",
            "gsconverter-tpu=gsconverter_tpu.main:main",
            "3dgsconv-tpu=gsconverter_tpu.main:main",
            "gsconv-tpu=gsconverter_tpu.main:main",
        ]
    },
)
