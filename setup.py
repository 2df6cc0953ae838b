from setuptools import find_packages, setup

setup(
    name="tombo-tpu",
    version="0.1.0",
    description=("TPU-native nanopore raw-signal modified-base analysis "
                 "(re-squiggle, modification detection, model estimation)"),
    packages=find_packages(include=["tombo_tpu", "tombo_tpu.*",
                                    "tombo_tpu_torch", "tombo_tpu_torch.*"]),
    package_data={"tombo_tpu": ["models/*.npz", "native/*.so"],
                  "tombo_tpu_torch": ["models/*.npz", "csrc/*"]},
    python_requires=">=3.10",
    install_requires=["numpy", "scipy", "h5py", "jax"],
    entry_points={
        "console_scripts": [
            "tombo-tpu = tombo_tpu.cli.main:main",
            "tombo-tpu-torch = tombo_tpu_torch.cli.main:main"],
    },
)
