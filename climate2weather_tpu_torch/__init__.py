"""climate2weather_tpu_torch — the PyTorch/CUDA port of climate2weather_tpu
for NVIDIA Hopper (H100).

It runs three paths of the JAX package. Sampling: the snapshot reader, the
ScoreUNet (with a hand-written CUDA attention kernel), the noise process, the
PC and DPM-Solver++(2M) samplers, Markov-blanket window scoring, detached
Gaussian guidance, calibration and the t=0 projection, and the
``exp.downscaling.run_arrays`` entry point. Predict from files: the
``experiment predict`` command (``exp.downscaling.run``) on grid, quantile
and training files read and written by its own HDF5 code. Training on one
card: the ndata-driven loop, the train step with AdamW and EMAs, checkpoints
and snapshots in the JAX package's formats, the dataset and sampler, and the
``train`` CLI, with the attention's gradient from a second CUDA kernel. The
Winograd conv of the JAX package is a third kernel (``ops.winograd``). It
imports torch and numpy only; the JAX package is its reference in the tests.

Subpackages: ``io`` (msgpack, YAML and HDF5 readers and writers), ``models``,
``diffusion``, ``training``, ``data`` (datasets, grids, normalization),
``ops`` (CUDA kernels, their plain versions, the autograd Functions and the
nvcc build), ``exp``, ``utils``. Sources of the kernels live in ``csrc/``.
"""
