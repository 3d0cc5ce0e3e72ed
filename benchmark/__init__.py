"""The benchmark of taichislam_tpu_torch: see run.py."""
