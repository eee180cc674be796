"""Utilities of the port: metric logging (``logging``), OBJ meshes
(``obj_io``), profiling (``profiler``: a ``torch.profiler`` trace and a
step timer) and the perf record (``perf``: ``PERF_TORCH.json``, never the
JAX package's ``PERF.json``).

The JAX package's ``utils/compile_cache.py`` has no counterpart: the nvcc
builds cached under ``pmce_tpu_torch/_build/`` (``ops/_cuda.py``) do its
job."""
