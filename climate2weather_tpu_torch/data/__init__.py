"""Data: windowed training datasets, the resumable sampler and the ordered
prefetch loader (port of climate2weather_tpu/data/dataset.py); labeled grids
and quantiles (``grid``) and normalization and layout helpers
(``pipeline``)."""
