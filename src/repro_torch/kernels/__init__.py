"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc/``),
each beside its plain PyTorch version.  Importing this package builds
nothing: ``_build.library()`` compiles on first launch."""
