"""Data of the port (ports of ``pmce_tpu/data``'s modules, same names):
clip windowing (``chunker``), synthetic sequences (``synthetic``), clip
batches (``clip_dataset``), the five dataset classes (``datasets``), packed
npz splits (``packed``), their construction from a config (``factory``),
the protocol evaluation (``evaluation``), joint sets (``kp_utils``),
augmentation (``aug``), the 2D detector-noise models (``noise``,
``noise_stats``), synthetic occluders (``occlusion``) and the offline ETL
of reference-format sources (``etl``; its joblib reader ``etl.joblib_io``
has no JAX counterpart)."""
