"""Data of the port: clip windowing, synthetic sequences, clip batches."""
