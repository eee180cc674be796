"""pmce-tpu in PyTorch and CUDA for NVIDIA Hopper: the PMCE serving forward,
Stage-1 lifter training, Stage-2 mesh training, the protocol evaluation
and the video demo, with their command-line entry points.

A port of the JAX package ``pmce_tpu`` (which stays the reference). It
imports torch and numpy, never jax. Sub-packages:

- ``pmce_tpu_torch.smpl``    SMPL artifacts, mesh coarsening, the SMPL layer
                             and its skinning kernel;
- ``pmce_tpu_torch.models``  pose lifter, co-evolution decoder, PMCE, and
                             the demo's backbones (SPIN's ResNet-50,
                             ViTPose);
- ``pmce_tpu_torch.ops``     geometry, Procrustes, metrics, coordinates and
                             the kernels: each a plain PyTorch version plus
                             a hand-written CUDA kernel (``csrc/``), picked
                             by tensor device;
- ``pmce_tpu_torch.core``    config, optimizer, losses, checkpoints and the
                             ``Trainer`` of both stages;
- ``pmce_tpu_torch.data``    clip windowing, synthetic sequences, batches,
                             the five dataset classes, packed npz files,
                             the dataset factory, the evaluation
                             protocols, keypoint conventions and the
                             joint augmentation;
- ``pmce_tpu_torch.demo``    the video demo: detector, tracker, crops,
                             camera fit, renderer and the pipeline;
- ``pmce_tpu_torch.native``  the demo's C++ rasterizer and tracker
                             assignment (g++ at first use, ctypes);
- ``pmce_tpu_torch.main``    the train, test and demo CLIs (``python -m``);
- ``pmce_tpu_torch.utils``   metric logging, OBJ meshes;
- ``pmce_tpu_torch.convert`` JAX parameter trees → reference state_dicts.

Start with ``pmce_tpu_torch.models.pmce.create_pmce(...)`` or
``core.trainer.Trainer``; both run on the card unless given
``device="cpu"``.
"""

__version__ = "0.1.0"
