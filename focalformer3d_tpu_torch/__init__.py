"""focalformer3d_tpu_torch: the PyTorch / CUDA port of focalformer3d_tpu.

The package mirrors the JAX package's layout (``configs``, ``data``, ``ops``,
``models``, ``core``, ``utils``) and is held against it module by module
(``tests/test_torch_*.py``). It imports torch and never JAX. Its inference
path, scan generator and random weights import nothing of the JAX package;
only the weight bridge ``utils.convert``, which the parity tests use, reads
the JAX package's numpy-only key mapping. The sparse-conv apply runs as a
hand-written CUDA kernel (``csrc/sparse_conv.cu``) on a card and as its
plain version on the CPU.
"""

__version__ = "0.1.0"
