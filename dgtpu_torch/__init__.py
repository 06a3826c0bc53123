"""dgtpu_torch — the PyTorch/CUDA port of dgtpu for NVIDIA Hopper GPUs.

The package mirrors ``dgtpu``'s module paths (``dgtpu/x/y.py`` ->
``dgtpu_torch/x/y.py``); the fused Pallas SoA V-cycle becomes
``ops/soa.py`` with hand-written CUDA kernels in ``csrc/soa_kernels.cu``.
It imports torch, numpy, scipy and yaml, never jax.

Dtypes are explicit: assembly, the defect matvec and the postprocessing
run in float64, the multigrid inner cycle in float32.  The device is
explicit too: nothing here picks one on the caller's behalf.
"""

__version__ = "0.1.0"
