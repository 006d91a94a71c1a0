"""The TPU probes of ``tools/micro_*.py`` (P1-P9) as micro-benchmarks of the
port's kernels on an NVIDIA H100.

One module per probe, named as its original: ``micro_mxu_probe`` (P1a,
P1b), ``micro_dotshape`` (P2), ``micro_dotshape2`` (P3), ``micro_kernel_v2``
(P4), ``micro_pallas_attr`` (P5), ``micro_gather_kernel`` (P6),
``micro_gather2`` (P7), ``micro_batch_grid`` (P8) and ``micro_meta9`` (P9).
Each has ``run(device, size)``, which returns one row per case (times,
rates and the bound on a card; the check of every kernel against its plain
version on either device), and ``main()``:

    python -m focalformer3d_tpu_torch.tools.micro_gather_kernel

runs the probe at its full size on the card and raises when there is none.
``tests/test_torch_cuda.py`` runs all nine at both sizes. Nothing runs at
import.
"""
