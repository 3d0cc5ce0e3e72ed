"""The port's measurement entry points: the five benchmark configurations
(``bench_configs``) and their fixtures (``gen_fixtures``), the secondary
benchmarks (``bench_secondary``), the SDF fidelity check against an
independent numpy model of the reference's fusion (``reference_math``,
``compare_vs_reference``) and the viewer's demo scene
(``viewer_demo_scene``). Each runs as ``python -m
taichislam_tpu_torch.tools.<name>``, on the CUDA card unless ``--cpu``
asks for the CPU."""
