"""Utilities of the port: metric logging (``logging``), OBJ meshes
(``obj_io``) and profiling (``profiler``: a ``torch.profiler`` trace and a
step timer).

The JAX package's ``utils/compile_cache.py`` has no counterpart: the nvcc
builds cached under ``pmce_tpu_torch/_build/`` (``ops/_cuda.py``) do its
job."""
