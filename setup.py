"""hamgnn_tpu package setup.

Console entry points mirror the reference's (setup.py:26-32: HamGNN2.0,
band_cal, graph_data_gen, poscar2openmx) plus the TPU-framework extras.
"""

from setuptools import find_packages, setup

setup(
    name="hamgnn_tpu",
    version="0.1.0",
    description=(
        "TPU-native E(3)-equivariant framework for predicting ab-initio "
        "tight-binding Hamiltonians (OpenMX/SIESTA/ABACUS), built on "
        "JAX/XLA/Pallas"
    ),
    packages=find_packages(include=["hamgnn_tpu", "hamgnn_tpu.*",
                                    "hamgnn_tpu_torch", "hamgnn_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy", "pyyaml",
    ],
    extras_require={"lmdb": ["lmdb"], "plot": ["matplotlib"]},
    entry_points={
        "console_scripts": [
            "HamGNN2.0 = hamgnn_tpu.cli:main",
            "hamgnn-tpu = hamgnn_tpu.cli:main",
            "band_cal = hamgnn_tpu.tools.band_cal:main",
            "band_cal_parallel = hamgnn_tpu.tools.band_cal_parallel:main",
            "graph_data_gen = hamgnn_tpu.tools.graph_data_gen:main",
            "graph_data_gen_siesta = hamgnn_tpu.tools.graph_data_gen_siesta:main",
            "graph_data_gen_abacus = hamgnn_tpu.tools.graph_data_gen_abacus:main",
            "poscar2openmx = hamgnn_tpu.tools.poscar2openmx:main",
            "poscar2abacus = hamgnn_tpu.tools.poscar2abacus:main",
            "poscar2siesta = hamgnn_tpu.tools.poscar2abacus:main_siesta",
            "wfn_export = hamgnn_tpu.tools.wfn_export:main",
            "npz_to_lmdb = hamgnn_tpu.tools.npz_to_lmdb:main",
            "uni_hamgnn = hamgnn_tpu.tools.uni_hamgnn:main",
            "hamgnn-magnetism = hamgnn_tpu.tools.magnetism:main",
        ]
    },
)
