"""focalformer3d_tpu_torch: the PyTorch / CUDA port of focalformer3d_tpu.

The package mirrors the JAX package's layout (``configs``, ``data``, ``ops``,
``models``, ``core``, ``utils``) and is held against it module by module
(``tests/test_torch_*.py``). It imports torch and never JAX, and nothing
of the JAX package (``tests/test_torch_imports.py`` checks every module):
where it needs a numpy-only piece of it, such as the reference checkpoint's
key mapping, it keeps its own copy (``utils/jax_keys.py``). The sparse
convs run as hand-written CUDA kernels (``csrc/``) on a card, forward and
backward, and as their plain versions on the CPU.
"""

__version__ = "0.1.0"
