"""Training data: windowed datasets, the resumable sampler and the ordered
prefetch loader (port of climate2weather_tpu/data/dataset.py)."""
