"""climate2weather_tpu_torch — the PyTorch/CUDA port of climate2weather_tpu
for NVIDIA Hopper (H100).

It runs the guided short-window downscaling path of the JAX package: the
snapshot reader, the ScoreUNet (with a hand-written CUDA attention kernel),
the noise process and DPM-Solver++(2M) step rules, Markov-blanket window
scoring, detached Gaussian guidance, calibration and the t=0 projection, and
the ``exp.downscaling.run_arrays`` entry point. It imports torch and numpy
only; the JAX package is its reference in the tests.

Subpackages: ``io`` (snapshot and YAML readers), ``models``, ``diffusion``,
``ops`` (CUDA kernels, their plain versions and the nvcc build), ``exp``,
``utils``. Sources of the kernels live in ``csrc/``.
"""
