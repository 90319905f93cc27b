"""climate2weather_tpu_torch — the PyTorch/CUDA port of climate2weather_tpu
for NVIDIA Hopper (H100).

It runs two paths of the JAX package. Sampling: the snapshot reader, the
ScoreUNet (with a hand-written CUDA attention kernel), the noise process and
DPM-Solver++(2M) step rules, Markov-blanket window scoring, detached Gaussian
guidance, calibration and the t=0 projection, and the
``exp.downscaling.run_arrays`` entry point. Training on one card: the
ndata-driven loop, the train step with AdamW and EMAs, checkpoints and
snapshots in the JAX package's formats, the dataset and sampler, and the
``train`` CLI, with the attention's gradient from a second CUDA kernel. It
imports torch and numpy only; the JAX package is its reference in the tests.

Subpackages: ``io`` (msgpack and YAML readers and writers), ``models``,
``diffusion``, ``training``, ``data``, ``ops`` (CUDA kernels, their plain
versions, the autograd Function and the nvcc build), ``exp``, ``utils``.
Sources of the kernels live in ``csrc/``.
"""
