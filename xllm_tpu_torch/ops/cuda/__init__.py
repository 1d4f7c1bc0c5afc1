"""Hand-written Hopper kernels of the served path, each beside its plain
PyTorch version and its launch counter (``_build.launch_counts``)."""
