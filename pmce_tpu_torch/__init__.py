"""pmce-tpu in PyTorch and CUDA: the PMCE serving forward for NVIDIA Hopper.

A port of the JAX package ``pmce_tpu`` (which stays the reference). It
imports torch and numpy, never jax. Sub-packages:

- ``pmce_tpu_torch.smpl``    SMPL artifacts and mesh coarsening assets;
- ``pmce_tpu_torch.models``  pose lifter, co-evolution decoder, PMCE;
- ``pmce_tpu_torch.ops``     the serving path's kernels: each a plain
                             PyTorch version plus a hand-written CUDA
                             kernel (``csrc/``), picked by tensor device;
- ``pmce_tpu_torch.convert`` JAX parameter tree → reference state_dict.

Start with ``pmce_tpu_torch.models.pmce.create_pmce(..., device=...)``.
"""

__version__ = "0.1.0"
