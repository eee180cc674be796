"""Command-line tools of the port, each ``python -m
pmce_tpu_torch.tools.<name>``.

Converters (ports of the JAX package's ``tools/convert_*.py``):
``convert_{h36m,pw3d,coco,mpii,mpii3d}`` turn reference-format dataset
sources into packed npz splits through ``data/etl`` (the SMPL synthesis on
the card unless ``--device cpu``), with ``etl_cli`` holding what they
share; ``convert_smpl_pkl`` and ``convert_mesh_downsampling`` turn the MPI
SMPL pickle and the COMA coarsening file into the npz artifacts the port
loads. Measurement on the card: ``compare_gru_scan``, ``compare_serving``
and ``profile_block_bwd`` (run as scripts; see their docstrings).
"""
